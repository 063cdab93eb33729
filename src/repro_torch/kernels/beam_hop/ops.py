"""Device dispatch for the fused beam hop (graph-traversal hot path)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.beam_hop.beam_hop import beam_hop_cuda
from repro_torch.kernels.beam_hop.ref import beam_hop_ref


def beam_hop(sel, neighbors, pool_i, pool_d, pool_v, queries, db,
             dist_backend: str = "f32", backend: Optional[str] = None):
    """One fused hop -> (pool_i, pool_d, pool_v, stats (Q, 2) int32)."""
    if dist_backend != "f32":
        raise NotImplementedError(
            f"beam_hop dist_backend={dist_backend!r}: the LUT mode comes "
            f"with lut_dist (ROADMAP Queue 2)")
    if use_kernel(db, backend, "beam_hop"):
        c = lambda t, dt: t.to(dt).contiguous()
        return beam_hop_cuda(c(sel, torch.int32), c(neighbors, torch.int32),
                             c(pool_i, torch.int32), c(pool_d, torch.float32),
                             c(pool_v, torch.bool), c(queries, torch.float32),
                             db)
    return beam_hop_ref(sel, neighbors, pool_i, pool_d, pool_v, queries, db)
