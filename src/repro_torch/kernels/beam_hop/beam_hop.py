"""Launch wrappers of the CUDA ``beam_hop`` kernel (``csrc/beam_hop.cu``):
``beam_hop_cuda`` in f32 mode, ``beam_hop_lut_cuda`` in LUT mode (the pq
and int8 backends). Each counts its own launches."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, pow2_at_least
from repro_torch.kernels.gather_dist.gather_dist import vec4_ok
from repro_torch.kernels.lut_dist.lut_dist import MAX_C, codes_vec4_ok

MAX_SORT = 2048          # ef + R, padded to a power of two


def _check_operands(name, sel, neighbors, pool_i, pool_d, pool_v, q_or_lut,
                    table, table_dtype):
    named = {"sel": (sel, torch.int32), "neighbors": (neighbors, torch.int32),
             "pool_i": (pool_i, torch.int32),
             "pool_d": (pool_d, torch.float32),
             "pool_v": (pool_v, torch.bool),
             "q_or_lut": (q_or_lut, torch.float32),
             "table": (table, table_dtype)}
    for arg, (t, dt) in named.items():
        if not t.is_cuda or t.device != table.device:
            raise ValueError(f"{name}: {arg} must be on {table.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    nq, ef = pool_i.shape
    n, d = table.shape
    if (sel.shape != (nq,) or pool_d.shape != (nq, ef)
            or pool_v.shape != (nq, ef) or q_or_lut.shape[:2] != (nq, d)
            or neighbors.dim() != 2 or neighbors.shape[0] != n or n == 0):
        raise ValueError(f"{name}: shapes disagree: sel {tuple(sel.shape)}, "
                         f"neighbors {tuple(neighbors.shape)}, pool "
                         f"{tuple(pool_i.shape)}, q_or_lut "
                         f"{tuple(q_or_lut.shape)}, table "
                         f"{tuple(table.shape)}")
    p = pow2_at_least(ef + neighbors.shape[1])
    if p > MAX_SORT:
        raise ValueError(f"{name}: ef + R = {ef + neighbors.shape[1]} "
                         f"exceeds {MAX_SORT}")
    return p


def _outputs(nq, ef, dev):
    return (torch.empty((nq, ef), dtype=torch.int32, device=dev),
            torch.empty((nq, ef), dtype=torch.float32, device=dev),
            torch.empty((nq, ef), dtype=torch.bool, device=dev),
            torch.empty((nq, 2), dtype=torch.int32, device=dev))


def beam_hop_cuda(sel, neighbors, pool_i, pool_d, pool_v, queries, db):
    """One fused f32 hop over all Q lanes; see ``ref.beam_hop_ref``."""
    if queries.dim() != 2:
        raise ValueError("beam_hop_cuda: queries must be (Q, D)")
    p = _check_operands("beam_hop_cuda", sel, neighbors, pool_i, pool_d,
                        pool_v, queries, db, torch.float32)
    lib = cuda_lib.library()
    nq, ef = pool_i.shape
    n, d = db.shape
    out = _outputs(nq, ef, db.device)
    code = lib.beam_hop_f32(
        sel.data_ptr(), neighbors.data_ptr(), pool_i.data_ptr(),
        pool_d.data_ptr(), pool_v.data_ptr(), queries.data_ptr(),
        db.data_ptr(), *(t.data_ptr() for t in out), nq, n,
        neighbors.shape[1], d, ef, p, int(vec4_ok(d, queries, db)),
        torch.cuda.current_stream(db.device).cuda_stream)
    cuda_lib.check(code, "beam_hop_f32")
    beam_hop_cuda.launches += 1
    return out


def beam_hop_lut_cuda(sel, neighbors, pool_i, pool_d, pool_v, lut, codes):
    """One fused LUT-mode hop: lut (Q, M, C) f32, codes (N, M) uint8; see
    ``ref.beam_hop_ref`` with ``dist_backend="pq"|"int8"``."""
    if lut.dim() != 3 or not 1 <= lut.shape[2] <= MAX_C:
        raise ValueError(f"beam_hop_lut_cuda: lut must be (Q, M, C) with "
                         f"C <= {MAX_C}, got {tuple(lut.shape)}")
    p = _check_operands("beam_hop_lut_cuda", sel, neighbors, pool_i, pool_d,
                        pool_v, lut, codes, torch.uint8)
    lib = cuda_lib.library()
    nq, ef = pool_i.shape
    n, m = codes.shape
    out = _outputs(nq, ef, codes.device)
    code = lib.beam_hop_lut(
        sel.data_ptr(), neighbors.data_ptr(), pool_i.data_ptr(),
        pool_d.data_ptr(), pool_v.data_ptr(), lut.data_ptr(),
        codes.data_ptr(), *(t.data_ptr() for t in out), nq, n,
        neighbors.shape[1], m, lut.shape[2], ef, p,
        int(codes_vec4_ok(m, codes)),
        torch.cuda.current_stream(codes.device).cuda_stream)
    cuda_lib.check(code, "beam_hop_lut")
    beam_hop_lut_cuda.launches += 1
    return out


beam_hop_cuda.launches = 0
beam_hop_lut_cuda.launches = 0
