"""Launch wrapper of the CUDA ``lut_dist`` kernel (``csrc/lut_dist.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

MAX_C = 256              # codes are uint8


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
                  ids: torch.Tensor) -> torch.Tensor:
    """lut (Q, M, C) f32, codes (N, M) uint8, ids (Q, R) int32 -> (Q, R)."""
    _check_operands(lut, codes, ids)
    lib = cuda_lib.library()
    q, m, c = lut.shape
    r = ids.shape[1]
    out = torch.empty((q, r), dtype=torch.float32, device=codes.device)
    code = lib.lut_dist_f32(
        lut.data_ptr(), codes.data_ptr(), ids.data_ptr(), out.data_ptr(),
        q, r, codes.shape[0], m, c, int(codes_vec4_ok(m, codes)),
        torch.cuda.current_stream(codes.device).cuda_stream)
    cuda_lib.check(code, "lut_dist_f32")
    lut_dist_cuda.launches += 1
    return out


lut_dist_cuda.launches = 0
