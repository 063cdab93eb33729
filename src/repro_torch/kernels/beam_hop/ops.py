"""Device dispatch for the fused beam hop (graph-traversal hot path)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.beam_hop.beam_hop import beam_hop_cuda, \
    beam_hop_lut_cuda, beam_hops_cuda, beam_hops_lut_cuda
from repro_torch.kernels.beam_hop.ref import beam_hop_ref, beam_hops_ref


def beam_hop(sel, neighbors, pool_i, pool_d, pool_v, q_or_lut, table,
             dist_backend: str = "f32", backend: Optional[str] = None,
             norms: Optional[torch.Tensor] = None):
    """One fused hop -> (pool_i, pool_d, pool_v, stats (Q, 2) int32).

    ``dist_backend="f32"``: q_or_lut is the (Q, D) queries, table the
    (N, D) base; ``"pq"``/``"int8"``: the (Q, M, C) LUT and the (N, M)
    uint8 codes (the callers have checked the name). The plain version
    also takes bf16 rows and ``norms`` (the prenorm distance); the one-hop
    kernel has neither mode (the hop loop, ``beam_hops``, has both) and
    raises on them.
    """
    if use_kernel(table, backend, "beam_hop"):
        if norms is not None or table.dtype == torch.bfloat16:
            raise ValueError("beam_hop: the one-hop kernel has no bf16-row "
                             "or prenorm mode; beam_hops runs them")
        c = lambda t, dt: t.to(dt).contiguous()
        head = (c(sel, torch.int32), c(neighbors, torch.int32),
                c(pool_i, torch.int32), c(pool_d, torch.float32),
                c(pool_v, torch.bool), c(q_or_lut, torch.float32))
        if dist_backend == "f32":
            return beam_hop_cuda(*head, table)
        return beam_hop_lut_cuda(*head, table.contiguous())
    return beam_hop_ref(sel, neighbors, pool_i, pool_d, pool_v, q_or_lut,
                        table, dist_backend, norms)


def beam_hops(neighbors, pool_i, pool_d, pool_v, hops, gathered, dup, stale,
              q_or_lut, table, dist_backend: str = "f32", *, k: int,
              max_iters: int, max_steps: int,
              patience: Optional[int] = None, eps: float = 0.0,
              backend: Optional[str] = None,
              norms: Optional[torch.Tensor] = None):
    """Up to ``max_steps`` guarded hops per lane in one call -> (pool_i,
    pool_d, pool_v, hops, gathered, dup_gathered, stale, iters, live); see
    ``ref.beam_hops_ref``. The operands as ``beam_hop``'s; in f32 mode the
    table may hold bf16 rows, and ``norms`` (N,) f32 selects the prenorm
    distance. On meta tensors (f32 mode) the outputs and the cost of
    ``max_steps`` hops for every lane, the fixed-beam ``fori`` cell's
    count; no launch."""
    if norms is not None and dist_backend != "f32":
        raise ValueError(f"norms (the prenorm distance) need f32 mode, got "
                         f"dist_backend={dist_backend!r}")
    kw = dict(k=k, max_iters=max_iters, max_steps=max_steps,
              patience=patience, eps=eps)
    if use_kernel(table, backend, "beam_hops", meta=dist_backend == "f32"):
        c = lambda t, dt: t.to(dt).contiguous()
        i32 = lambda t: c(t, torch.int32)
        head = (i32(neighbors), i32(pool_i), c(pool_d, torch.float32),
                c(pool_v, torch.bool), i32(hops), i32(gathered), i32(dup),
                i32(stale), c(q_or_lut, torch.float32))
        if dist_backend == "f32":
            return beam_hops_cuda(*head, table, norms=norms, **kw)
        return beam_hops_lut_cuda(*head, table.contiguous(), **kw)
    return beam_hops_ref(neighbors, pool_i, pool_d, pool_v, hops, gathered,
                         dup, stale, q_or_lut, table, norms=norms, **kw)
