"""Three-term roofline of one step on an NVIDIA H100 SXM (the reference's
``analysis/roofline.py``, which prices a TPU v5e):

    compute_s    = sum over dtypes of FLOPs_per_device[dtype] / peak[dtype]
    memory_s     = bytes_per_device / HBM_BW
    collective_s = link_bytes_per_device / LINK_BW

The reference reads its FLOPs and bytes from the compiled HLO; the port's
come from ``analysis.op_costs.CostCounter``, which saw every ATen op and
kernel launch of one eager run of the step (``launch/dryrun.py``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

# -- NVIDIA H100 SXM5 80GB, dense (no sparsity), from NVIDIA's H100 Tensor
#    Core GPU data sheet ------------------------------------------------------
CARD = "NVIDIA H100 80GB HBM3"       # the name torch reports for it
PEAK_FLOPS_BF16 = 989e12             # FLOP/s, bf16 / fp16 tensor cores
PEAK_FLOPS_TF32 = 495e12             # FLOP/s, TF32 tensor cores
PEAK_FLOPS_F32 = 67e12               # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12                     # B/s, HBM3
LINK_BW = 450e9                      # B/s, NVLink 4 per direction (900 GB/s
                                     # both ways); replaces the v5e ICI_BW
HBM_BYTES = 80e9                     # the card's memory
SM_COUNT = 132                       # SMs; the kernels' routes on meta
L2_BYTES = 50 * 1024 * 1024          # L2 cache

# the peak an op's FLOPs run at, by the dtype the counter files them under
PEAK_BY_DTYPE = {"bf16": PEAK_FLOPS_BF16, "f16": PEAK_FLOPS_BF16,
                 "tf32": PEAK_FLOPS_TF32, "f32": PEAK_FLOPS_F32,
                 "f64": PEAK_FLOPS_F32 / 2, "int": PEAK_FLOPS_F32}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    link_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0           # analytic 6ND / 2ND
    useful_ratio: float = 0.0          # model_flops / (flops * devices)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    collective_counts: Optional[Dict[str, int]] = None
    notes: str = ""

    def to_dict(self):
        return asdict(self)


def compute_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """Each dtype's FLOPs over its peak, summed."""
    return sum(f / PEAK_BY_DTYPE[dt] for dt, f in flops_by_dtype.items())


def analyze(costs, *, arch: str, shape: str, mesh_desc: str,
            n_devices: int, model_flops: float = 0.0, notes: str = "",
            arg_bytes: int = 0, temp_bytes: int = 0,
            out_bytes: int = 0) -> RooflineReport:
    """``costs``: a ``op_costs.DeviceCosts`` (one device's FLOPs by dtype,
    bytes, link bytes and collective counts)."""
    flops = sum(costs.flops.values())
    compute_s = compute_seconds(costs.flops)
    memory_s = costs.bytes / HBM_BW
    collective_s = costs.link_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    useful = (model_flops / (flops * n_devices)
              if flops and model_flops else 0.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=costs.bytes,
        link_bytes_per_device=costs.link_bytes, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get), model_flops=model_flops,
        useful_ratio=useful, arg_bytes=arg_bytes, temp_bytes=temp_bytes,
        out_bytes=out_bytes,
        collective_counts=dict(costs.collective_counts), notes=notes)


def lm_model_flops(cfg, shape, kind: str) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·tokens train, 2·N_active·tokens fwd."""
    n = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence + attention over the cache
    tokens = shape.global_batch
    attn = (2.0 * shape.global_batch * shape.seq_len
            * cfg.n_layers * cfg.n_heads * cfg.head_dim * 2)
    return 2.0 * n * tokens + attn


def hbm_fit(report: RooflineReport, budget_bytes: float = HBM_BYTES) -> bool:
    return (report.arg_bytes + report.temp_bytes
            + report.out_bytes) <= budget_bytes
