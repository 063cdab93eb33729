"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

It lists the reference's eleven ids, all of which the port runs: the
paper's ANN workload, the four recsys models (DLRM, two-tower retrieval,
SASRec, DIN), the five LMs (the dense qwen2-1.5b, mistral-nemo-12b and
qwen3-32b; the MoE deepseek-moe-16b and the MoE + MLA deepseek-v2-236b)
and the GNN, dimenet.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import ann_laion, deepseek_moe_16b, \
    deepseek_v2_236b, dimenet, din, dlrm_mlperf, mistral_nemo_12b, \
    qwen2_1_5b, qwen3_32b, sasrec, two_tower_retrieval
from repro_torch.configs.base import (  # noqa: F401
    ANNConfig, ArchSpec, GNNConfig, LMConfig, RecsysConfig, ShapeConfig,
    GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, reduced_lm,
)

_REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in [
        qwen3_32b.SPEC, qwen2_1_5b.SPEC, mistral_nemo_12b.SPEC,
        deepseek_v2_236b.SPEC, deepseek_moe_16b.SPEC, dimenet.SPEC,
        sasrec.SPEC, two_tower_retrieval.SPEC, dlrm_mlperf.SPEC, din.SPEC,
        ann_laion.SPEC]
}

# the ten assigned architectures, in the registry's (the reference's) order
ASSIGNED_ARCHS: List[str] = [a for a in _REGISTRY if a != "ann-laion"]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {list_archs()}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def iter_cells(include_ann: bool = False):
    """Yield (arch_id, shape_name, skip_reason) for every assigned cell
    (and the ANN workload's with ``include_ann``)."""
    archs = list(_REGISTRY) if include_ann else ASSIGNED_ARCHS
    for arch_id in archs:
        spec = _REGISTRY[arch_id]
        for shape_name in spec.shapes:
            yield arch_id, shape_name, spec.skip_reason(shape_name)
