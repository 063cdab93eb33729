"""Launch wrapper of the CUDA ``beam_hop`` kernel (``csrc/beam_hop.cu``),
f32 mode."""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, pow2_at_least
from repro_torch.kernels.gather_dist.gather_dist import vec4_ok

MAX_SORT = 2048          # ef + R, padded to a power of two


def _check_operands(sel, neighbors, pool_i, pool_d, pool_v, queries, db):
    named = {"sel": sel, "neighbors": neighbors, "pool_i": pool_i,
             "pool_d": pool_d, "pool_v": pool_v, "queries": queries,
             "db": db}
    types = {"sel": torch.int32, "neighbors": torch.int32,
             "pool_i": torch.int32, "pool_d": torch.float32,
             "pool_v": torch.bool, "queries": torch.float32,
             "db": torch.float32}
    for name, t in named.items():
        if not t.is_cuda or t.device != db.device:
            raise ValueError(f"beam_hop_cuda: {name} must be on {db.device}")
        if t.dtype != types[name]:
            raise TypeError(f"beam_hop_cuda: {name} must be {types[name]}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"beam_hop_cuda: {name} is not contiguous")
    nq, ef = pool_i.shape
    n, d = db.shape
    if (sel.shape != (nq,) or pool_d.shape != (nq, ef)
            or pool_v.shape != (nq, ef) or queries.shape != (nq, d)
            or neighbors.dim() != 2 or neighbors.shape[0] != n or n == 0):
        raise ValueError("beam_hop_cuda: shapes disagree: sel "
                         f"{tuple(sel.shape)}, neighbors "
                         f"{tuple(neighbors.shape)}, pool {tuple(pool_i.shape)}"
                         f", queries {tuple(queries.shape)}, db "
                         f"{tuple(db.shape)}")


def beam_hop_cuda(sel, neighbors, pool_i, pool_d, pool_v, queries, db):
    """One fused hop over all Q lanes; see ``ref.beam_hop_ref``."""
    _check_operands(sel, neighbors, pool_i, pool_d, pool_v, queries, db)
    lib = cuda_lib.library()
    nq, ef = pool_i.shape
    n, d = db.shape
    r = neighbors.shape[1]
    p = pow2_at_least(ef + r)
    if p > MAX_SORT:
        raise ValueError(f"beam_hop_cuda: ef + R = {ef + r} exceeds "
                         f"{MAX_SORT}")
    dev = db.device
    out_i = torch.empty((nq, ef), dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, ef), dtype=torch.float32, device=dev)
    out_v = torch.empty((nq, ef), dtype=torch.bool, device=dev)
    stats = torch.empty((nq, 2), dtype=torch.int32, device=dev)
    code = lib.beam_hop_f32(
        sel.data_ptr(), neighbors.data_ptr(), pool_i.data_ptr(),
        pool_d.data_ptr(), pool_v.data_ptr(), queries.data_ptr(),
        db.data_ptr(), out_i.data_ptr(), out_d.data_ptr(), out_v.data_ptr(),
        stats.data_ptr(), nq, n, r, d, ef, p,
        int(vec4_ok(d, queries, db)),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, "beam_hop_f32")
    beam_hop_cuda.launches += 1
    return out_i, out_d, out_v, stats


beam_hop_cuda.launches = 0
