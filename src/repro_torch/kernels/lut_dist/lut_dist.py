"""Launch wrapper of the CUDA ``lut_dist`` kernels (``csrc/lut_dist.cu``).

Two variants compute the same function, bit for bit; ``route`` picks one by
the number of (q, r) pairs, and each counts its own launches in
``lut_dist_cuda.by_variant`` (``lut_dist_cuda.launches`` is their sum):

- ``warp`` (at most ``WARP_MAX_PAIRS`` pairs): one warp per pair, its
  lookups issued together (the quantized pool seed's Q x 1);
- ``thread``: one thread per pair, for calls whose pairs already fill the
  card (the staged LUT hop's Q x R).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib

MAX_C = 256              # codes are uint8
VARIANTS = ("thread", "warp")     # the C entry point's variant codes
# The largest pair count routed to the warp variant. Measured at Q = 1024,
# R = 1 ... 32 (benchmarks/torch_kernel_times.py, NVIDIA H100 80GB HBM3,
# 700 W, device ms, warp / thread, two runs): up to R = 8 the warp variant
# is faster (M = 300: 0.0596 / 0.0695; M = 600: 0.1226 / 0.1291 and
# 0.1223 / 0.1297), from R = 16 the thread variant (0.0853 / 0.0834;
# 0.1789 / 0.1597), whose warps of one query share each 1 KB sub-table.
WARP_MAX_PAIRS = 8192


def route(pairs: int, variant: Optional[str] = None) -> str:
    """The variant a call of ``pairs`` (q, r) pairs takes; ``variant``
    forces one (tests, measurements). Both take every shape."""
    if variant is None:
        return "warp" if pairs <= WARP_MAX_PAIRS else "thread"
    if variant not in VARIANTS:
        raise ValueError(f"lut_dist_cuda: unknown variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    return variant


def _check_operands(lut, codes, ids):
    for name, t, dt in (("lut", lut, torch.float32),
                        ("codes", codes, torch.uint8),
                        ("ids", ids, torch.int32)):
        if not t.is_cuda or t.device != codes.device:
            raise ValueError(f"lut_dist_cuda: {name} must be on "
                             f"{codes.device}")
        if t.dtype != dt:
            raise TypeError(f"lut_dist_cuda: {name} must be {dt}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lut_dist_cuda: {name} is not contiguous")
    if lut.dim() != 3 or codes.dim() != 2 or ids.dim() != 2:
        raise ValueError("lut_dist_cuda: expected (Q, M, C), (N, M), (Q, R)")
    q, m, c = lut.shape
    if codes.shape[1] != m or ids.shape[0] != q or codes.shape[0] == 0:
        raise ValueError(f"lut_dist_cuda: shapes {tuple(lut.shape)}, "
                         f"{tuple(codes.shape)}, {tuple(ids.shape)} disagree")
    if not 1 <= c <= MAX_C or m < 1:
        raise ValueError(f"lut_dist_cuda: C = {c} outside 1..{MAX_C}, or "
                         f"M = {m} < 1")


def codes_vec4_ok(m: int, codes: torch.Tensor) -> bool:
    """Code rows can be read as uchar4: M % 4 == 0 and a 4-byte aligned
    base (so every row is aligned)."""
    return m % 4 == 0 and codes.data_ptr() % 4 == 0


def lut_dist_cuda(lut: torch.Tensor, codes: torch.Tensor,
                  ids: torch.Tensor,
                  variant: Optional[str] = None) -> torch.Tensor:
    """lut (Q, M, C) f32, codes (N, M) uint8, ids (Q, R) int32 -> (Q, R).
    The variant is ``route``'s unless one is forced."""
    _check_operands(lut, codes, ids)
    lib = cuda_lib.library()
    q, m, c = lut.shape
    r = ids.shape[1]
    variant = route(q * r, variant)
    out = torch.empty((q, r), dtype=torch.float32, device=codes.device)
    if q * r == 0:
        return out                       # nothing to launch
    code = lib.lut_dist_f32(
        lut.data_ptr(), codes.data_ptr(), ids.data_ptr(), out.data_ptr(),
        q, r, codes.shape[0], m, c, int(codes_vec4_ok(m, codes)),
        VARIANTS.index(variant),
        torch.cuda.current_stream(codes.device).cuda_stream)
    cuda_lib.check(code, f"lut_dist_f32 ({variant})")
    lut_dist_cuda.launches += 1
    lut_dist_cuda.by_variant[variant] += 1
    return out


lut_dist_cuda.launches = 0
lut_dist_cuda.by_variant = dict.fromkeys(VARIANTS, 0)
