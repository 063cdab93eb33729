"""Token-choice MoE (the reference's ``models/moe.py``): DeepSeek-style
shared experts plus routed top-k, with GShard's capacity dispatch.

    moe = moe_init(generator, cfg)         # an nn.Module: moe["router"] ...
    out, aux = moe_apply(moe, cfg, x)      # x (B, S, d)

The router is a float32 (d, E) matrix even in a bf16 config; the experts
are (E, d, m) / (E, m, d) in the config's type, and the shared experts one
SwiGLU of width ``n_shared_experts * moe_d_ff``. ``_route`` takes the
softmax of ``x.float() @ router``, its top-k (ties to the lower expert, as
``lax.top_k``), renormalizes the k weights by ``max(sum, 1e-9)`` and gives
DeepSeek's aux loss ``E * sum_e f_e * mean_p_e / k``.

Dispatch keeps the reference's semantics. Tokens, flattened in (b, s)
order, split into ``g`` groups of ``gs``; each expert takes ``cap`` tokens
per group. A (token, choice) pair's slot is its position in its expert's
queue inside the group, counted over the group's pairs token-major and
choice-minor; a pair whose position reaches ``cap`` is dropped. The
reference builds (g, gs, k, E, C) one-hot tensors and contracts them; the
port moves rows instead, which gives the same numbers (the one-hot
products are exact copies, an empty slot gives 0):

  * each slot's token is found once (an integer scatter, one writer per
    slot) and the slots' rows are gathered from x: an (E, g * cap, d)
    batch, empty slots zero;
  * the experts run as batched products over E:
    ``silu(in @ w_gate[e]) * (in @ w_up[e]) @ w_down[e]``;
  * each kept pair's output row is gathered back, times its weight cast
    to x's type, and a token's terms are summed in ascending expert id
    in float32 (the order of the contraction's non-zero terms), then
    cast to x's type.

Both row moves are gathers in the forward and in the backward pass (the
backward of one is the other's gather, ``_MoveRows``), so no float atomic
runs in either. The router's gradient reaches it through the combine
weights and the aux term, as in the reference, whose one-hot tensors carry
none. The reference pins the dispatch tensors' shardings on a mesh when
its ``MOE_SHARD_CONSTRAINTS`` is set; on one device there is no placement
to pin, and the port has no such flag.

``routing_log()`` records, while it is open, each call's routed ids,
per-expert pair counts, kept pairs and slots (tensors left on the
device, so no host sync on the path): the drop share, the experts a step
touched, and where two runs routed a token apart. ``forced_routing(ids)``
routes each call, while it is open, to given expert ids instead, so that
two runs of one sequence in bf16 can be held to each other where rounding
alone would send a near-tie token to another expert.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, init_device, lm_dtype, \
    swiglu_apply, swiglu_init


class MoE(nn.Module):
    """The router, the stacked routed experts and the shared SwiGLU (or
    None), under the reference's names; ``moe["w_gate"]`` reads as the
    reference's ``p["w_gate"]``."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 shared: Optional[nn.ParameterDict] = None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w_gate = nn.Parameter(w_gate)
        self.w_up = nn.Parameter(w_up)
        self.w_down = nn.Parameter(w_down)
        self.shared = shared

    def __getitem__(self, key: str):
        return getattr(self, key)


def moe_init(generator: torch.Generator, cfg, device=None) -> MoE:
    """The reference's recipe on the generator's device: the router
    N(0, 1/d) in float32, the experts N(0, 1/d) (gate, up) and N(0, 1/m)
    (down) cast to the config's type one tensor at a time, the shared
    experts from ``swiglu_init``."""
    dt = lm_dtype(cfg)
    dev = init_device(generator, device)
    d, e, m = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dt)

    router = dense_init(generator, d, e, dev)
    w_gate = normal((e, d, m), d ** -0.5)
    w_up = normal((e, d, m), d ** -0.5)
    w_down = normal((e, m, d), m ** -0.5)
    shared = swiglu_init(generator, d, cfg.n_shared_experts * m, dt, dev) \
        if cfg.n_shared_experts else None
    return MoE(router, w_gate, w_up, w_down, shared)


def _route(logits: torch.Tensor, top_k: int,
           idx: Optional[torch.Tensor] = None):
    """(T, E) float32 -> (weights (T, k), expert ids (T, k) int64, aux
    loss). The top k by a stable descending sort: among equal
    probabilities the lower expert id comes first, as ``lax.top_k``.
    Given ``idx`` (T, k), those ids are taken instead of the top k."""
    probs = torch.softmax(logits, dim=-1)
    if idx is None:
        idx = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :top_k]
    w = probs.gather(1, idx)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    t, e = logits.shape
    flat = idx.reshape(-1)
    # bincount(flat, minlength=e) with its length fixed (every id < e):
    # the same counts, and a shape the meta device can give
    counts = torch.zeros((e,), dtype=torch.int64, device=idx.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    f = counts.float() / t
    aux = e * (f * probs.mean(0)).sum() / top_k
    return w, idx, aux


def groups_and_capacity(cfg, t: int):
    """(groups g, group size gs, capacity cap) for ``t`` tokens, in the
    reference's Python arithmetic; ``t`` must split into g whole groups."""
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    g = max(1, t // min(cfg.moe_group_size, t))
    gs = t // g
    if g * gs != t:
        raise ValueError(f"tokens {t} not divisible by groups {g}")
    return g, gs, max(k, int(gs * k * cfg.moe_capacity_factor / e) + 1)


def dispatch_slots(idx: torch.Tensor, g: int, e: int, cap: int):
    """Expert ids (T, k) of T = g * gs tokens -> each pair's slot (T, k)
    in an (E, g, cap) layout, ``E * g * cap`` for a dropped pair.

    A pair's position is the count of the group's earlier pairs
    (token-major, choice-minor) routed to its expert; from ``cap`` on it
    is dropped."""
    t, k = idx.shape
    pair_e = idx.reshape(g, -1)                               # (g, gs*k)
    onehot = F.one_hot(pair_e, e).to(torch.int32)             # (g, gs*k, E)
    pos = onehot.cumsum(1).gather(2, pair_e[..., None])[..., 0] - 1
    grp = torch.arange(g, device=idx.device)[:, None]
    slot = (pair_e * g + grp) * cap + pos
    slot = torch.where(pos < cap, slot, e * g * cap)
    return slot.reshape(t, k)


class _MoveRows(torch.autograd.Function):
    """``out = src'[fwd]``, where ``src'`` is ``src`` (n, d) with a zero
    row appended at index n. Its backward is the gather ``grad_src =
    grad'[bwd]`` (``grad'``: the incoming gradient flattened to rows, a
    zero row appended), summed over ``bwd``'s second axis in order when
    it has one. ``fwd`` and ``bwd`` are each other's inverse maps, so
    neither direction scatters."""

    @staticmethod
    def forward(ctx, src, fwd, bwd):
        ctx.save_for_backward(bwd)
        return _pad_row(src)[fwd]

    @staticmethod
    def backward(ctx, grad):
        (bwd,) = ctx.saved_tensors
        rows = _pad_row(grad.reshape(-1, grad.shape[-1]))[bwd]
        if bwd.dim() == 2:
            acc = rows[:, 0]
            for j in range(1, bwd.shape[1]):
                acc = acc + rows[:, j]
            rows = acc
        return rows, None, None


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[-1]))])


_LOG: Optional[List[dict]] = None
_FORCED: Optional[Iterator[torch.Tensor]] = None


@contextlib.contextmanager
def routing_log():
    """Record each ``moe_apply`` call's routing while open: a list of
    {"ids": (T, k) expert ids, "counts": (E,) pairs routed to each
    expert, "kept": pairs in capacity, "pairs": T * k, "slots": E * g *
    cap}; the tensors stay on the device."""
    global _LOG
    prev, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = prev


@contextlib.contextmanager
def forced_routing(ids: List[torch.Tensor]):
    """While open, the n-th ``moe_apply`` call takes ``ids[n]`` ((T, k)
    int64 expert ids on x's device) as its routing instead of its top k;
    the weights are the router's probabilities at those ids,
    renormalized. A call past the end of ``ids`` raises."""
    global _FORCED
    prev, _FORCED = _FORCED, iter(ids)
    try:
        yield
    finally:
        _FORCED = prev


def moe_apply(p: MoE, cfg, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d) in x's type, aux loss float32)."""
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    t = b * s
    g, _, cap = groups_and_capacity(cfg, t)
    xt = x.reshape(t, d)
    forced = None
    if _FORCED is not None:
        forced = next(_FORCED, None)
        if forced is None:
            raise RuntimeError("forced_routing: more moe_apply calls than "
                               "routings given")
    w, idx, aux = _route(xt.float() @ p["router"], k, forced)
    slot = dispatch_slots(idx, g, e, cap)                      # (T, k)
    n_slots = e * g * cap
    dev = x.device
    if _LOG is not None:
        _LOG.append({"ids": idx,
                     "counts": torch.bincount(idx.reshape(-1), minlength=e),
                     "kept": (slot < n_slots).sum(), "pairs": t * k,
                     "slots": n_slots})
    # a token's pairs in ascending expert id: the order of the sum
    order = idx.argsort(-1)
    slot = slot.gather(1, order)
    w = w.gather(1, order)
    pair = torch.arange(t * k, device=dev)
    # each slot's token (t: empty) and pair (t * k: empty); the dropped
    # pairs all land on the extra entry n_slots, which is cut off
    slot_tok = torch.full((n_slots + 1,), t, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, slot.reshape(-1), pair // k)
    slot_pair = torch.full((n_slots + 1,), t * k, dtype=torch.int64,
                           device=dev)
    slot_pair.scatter_(0, slot.reshape(-1), pair)
    slot_tok, slot_pair = slot_tok[:n_slots], slot_pair[:n_slots]

    xin = _MoveRows.apply(xt, slot_tok, slot).reshape(e, g * cap, d)
    h = F.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    eo = torch.bmm(h, p["w_down"]).reshape(n_slots, d)
    del xin, h
    rows = _MoveRows.apply(eo, slot, slot_pair)                # (T, k, d)
    wk = w.to(x.dtype).float()
    out = wk[:, 0, None] * rows[:, 0].float()
    for j in range(1, k):
        out = out + wk[:, j, None] * rows[:, j].float()
    out = out.to(x.dtype).reshape(b, s, d)
    if p["shared"] is not None:
        out = out + swiglu_apply(p["shared"], x)
    return out, aux.float()
