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
none. On a mesh, ``moe_apply_tp`` runs one batch group's layer with its
experts split over ``model``: the placement the reference's
``MOE_SHARD_CONSTRAINTS`` pins (``flags.py``).

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


def _route_stats(logits: torch.Tensor, top_k: int,
                 idx: Optional[torch.Tensor] = None):
    """(T, E) float32 -> (weights (T, k), expert ids (T, k) int64, the
    (E,) count of pairs routed to each expert, the probabilities (T, E)).
    The top k by a stable descending sort: among equal probabilities the
    lower expert id comes first, as ``lax.top_k``. Given ``idx`` (T, k),
    those ids are taken instead of the top k."""
    probs = torch.softmax(logits, dim=-1)
    if idx is None:
        idx = torch.sort(probs.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :top_k]
    w = probs.gather(1, idx)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(-1)
    # bincount(flat, minlength=e) with its length fixed (every id < e):
    # the same counts, and a shape the meta device can give
    counts = torch.zeros((logits.shape[1],), dtype=torch.int64,
                         device=idx.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    return w, idx, counts, probs


def _route(logits: torch.Tensor, top_k: int,
           idx: Optional[torch.Tensor] = None):
    """(T, E) float32 -> (weights (T, k), expert ids (T, k) int64, aux
    loss ``E * sum_e f_e * mean_p_e / k``): ``_route_stats``."""
    w, idx, counts, probs = _route_stats(logits, top_k, idx)
    t, e = logits.shape
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
    cap, "dropped": (T, k) the pairs past capacity}; the tensors stay on
    the device. A tensor-parallel program logs one entry per layer, its
    batch groups' pieces joined (``MeshRouting.flush_log``)."""
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


def _next_forced() -> torch.Tensor:
    ids = next(_FORCED, None)
    if ids is None:
        raise RuntimeError("forced_routing: more moe_apply calls than "
                           "routings given")
    return ids


def moe_apply(p: MoE, cfg, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d) in x's type, aux loss float32)."""
    b, s, d = x.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    t = b * s
    g, _, cap = groups_and_capacity(cfg, t)
    xt = x.reshape(t, d)
    forced = None if _FORCED is None else _next_forced()
    w, idx, aux = _route(xt.float() @ p["router"], k, forced)
    slot = dispatch_slots(idx, g, e, cap)                      # (T, k)
    n_slots = e * g * cap
    if _LOG is not None:
        _LOG.append({"ids": idx,
                     "counts": torch.bincount(idx.reshape(-1), minlength=e),
                     "kept": (slot < n_slots).sum(), "pairs": t * k,
                     "slots": n_slots, "dropped": slot == n_slots})
    slot, w, slot_tok, slot_pair = _slot_maps(idx, w, slot, n_slots)
    out = _experts(p, xt, slot, slot_tok, slot_pair, w, g * cap)
    out = out.to(x.dtype).reshape(b, s, d)
    if p["shared"] is not None:
        out = out + swiglu_apply(p["shared"], x)
    return out, aux.float()


def _slot_maps(idx, w, slot, n_slots: int):
    """A token's pairs in ascending expert id (the order of the combine's
    sum): (slots (T, k), weights (T, k)) so sorted, and each slot's token
    (T: empty) and pair (T * k: empty), (n_slots,) each."""
    t, k = idx.shape
    dev = idx.device
    order = idx.argsort(-1)
    slot = slot.gather(1, order)
    w = w.gather(1, order)
    pair = torch.arange(t * k, device=dev)
    # the dropped pairs all land on the extra entry n_slots, cut off
    slot_tok = torch.full((n_slots + 1,), t, dtype=torch.int64, device=dev)
    slot_tok.scatter_(0, slot.reshape(-1), pair // k)
    slot_pair = torch.full((n_slots + 1,), t * k, dtype=torch.int64,
                           device=dev)
    slot_pair.scatter_(0, slot.reshape(-1), pair)
    return slot, w, slot_tok[:n_slots], slot_pair[:n_slots]


def _experts(p, xt, slot, slot_tok, slot_pair, w, width: int,
             base: int = 0):
    """The experts of ``p`` (E' of them) on their slots, ``width`` a
    expert: slots ``base`` to ``base + E' * width`` of the layout.
    xt (T, d); slot (T, k) sorted; slot_tok / slot_pair: those slots'
    tokens and pairs -> the float32 (T, d) sum of each token's kept pairs
    held here, weights cast to xt's type, in ascending expert id."""
    t, d = xt.shape
    k = slot.shape[1]
    e = p["w_gate"].shape[0]
    n = e * width
    if base or n < slot_tok.shape[0]:           # a shard's experts
        slot = torch.where((slot >= base) & (slot < base + n), slot - base,
                           n)
        slot_tok = slot_tok[base:base + n]
        slot_pair = slot_pair[base:base + n]
    xin = _MoveRows.apply(xt, slot_tok, slot).reshape(e, width, d)
    h = F.silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    eo = torch.bmm(h, p["w_down"]).reshape(n, d)
    del xin, h
    rows = _MoveRows.apply(eo, slot, slot_pair)                # (T, k, d)
    wk = w.to(xt.dtype).float()
    out = wk[:, 0, None] * rows[:, 0].float()
    for j in range(1, k):
        out = out + wk[:, j, None] * rows[:, j].float()
    return out


# ------------------------------------------- expert parallel (``model``)
# One batch group's MoE layer over a mesh's ``model`` axis (the reference's
# rules: routed experts split on their expert axis, the shared experts
# column- then row-parallel, the router replicated), as the reference's
# ``MOE_SHARD_CONSTRAINTS`` places it: dispatch groups over the data axes,
# experts over ``model``.

class MeshRouting:
    """The MoE bookkeeping of one tensor-parallel program, shared by its
    batch groups (``models.transformer``'s mesh path), which one process
    runs in group order. ``parts``: the batch groups the tokens split over
    (1 where every group runs all of them). Per MoE layer: each group's
    (g, E) counts of pairs by dispatch group (the exclusive scan's
    inputs where a dispatch group spans batch groups), the router's
    statistics for the aux loss, the forced routing drawn once, and the
    routing log's pieces."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.parts = 1                  # set by the program's runner
        self.counts = {}        # (layer, part) -> (g, E) int64
        self.stats = {}         # layer -> {part: (counts (E,), prob sums)}
        self.forced = {}        # layer -> (T, k) ids
        self.log = {}           # layer -> {part: entry}
        self.tokens = {}        # layer -> the tokens of every group

    def part(self, grp) -> int:
        """Which of ``parts`` batch group ``grp`` runs."""
        return grp.g if self.parts > 1 else 0

    def forced_ids(self, layer: int, lo: int, n: int, device):
        """Rows ``lo`` to ``lo + n`` of the layer's forced ids (the next
        ``forced_routing`` entry, drawn by the first group to ask), or
        None."""
        if _FORCED is None:
            return None
        if layer not in self.forced:
            self.forced[layer] = _next_forced()
        return self.forced[layer][lo:lo + n].to(device)

    def aux_loss(self, cfg) -> torch.Tensor:
        """The layers' aux losses summed: for each, the groups' pair counts
        and probability sums reduced over the data axes (two (E,)
        all-reduces), then ``E * sum_e f_e * mean_p_e / k`` over all the
        layer's tokens."""
        from repro_torch.distributed import tensor_parallel as TP
        home = self.mesh.devices.reshape(-1)[0]
        e, k = cfg.n_routed_experts, cfg.moe_top_k
        total = torch.zeros((), dtype=torch.float32, device=home)
        for layer in sorted(self.stats):
            parts = [self.stats[layer][p] for p in sorted(self.stats[layer])]
            t = self.tokens[layer]
            counts = TP.data_all_reduce(self.mesh, [c for c, _ in parts],
                                        self.parts)
            psum = TP.data_all_reduce(self.mesh, [q for _, q in parts],
                                      self.parts)
            f = counts.float() / t
            total = total + e * (f * (psum / t)).sum() / k
        return total

    def flush_log(self) -> None:
        """Append each layer's routing, the groups' pieces joined in group
        order, to the open ``routing_log`` (as ``moe_apply`` logs one
        call)."""
        if _LOG is None:
            return
        home = self.mesh.devices.reshape(-1)[0]
        for layer in sorted(self.log):
            pieces = [self.log[layer][p] for p in sorted(self.log[layer])]
            _LOG.append({
                "ids": torch.cat([q["ids"].to(home) for q in pieces]),
                "counts": sum(q["counts"].to(home) for q in pieces),
                "kept": sum(q["kept"].to(home) for q in pieces),
                "pairs": sum(q["pairs"] for q in pieces),
                "slots": pieces[0]["slots"],
                "dropped": torch.cat([q["dropped"].to(home)
                                      for q in pieces])})


def _earlier(counts, g: int, e: int, device) -> torch.Tensor:
    """The earlier batch groups' (g, E) counts summed (zeros for the
    first): a group's share of the exclusive scan."""
    out = torch.zeros((g, e), dtype=torch.int64, device=device)
    for c in counts:
        out = out + c.to(device)
    return out


def _straddle_slots(idx, lo: int, gs: int, e: int, cap: int, before):
    """Slots of the T_l tokens from global token ``lo`` on, whose dispatch
    groups of ``gs`` tokens also hold other batch groups' tokens: the
    (E, gl, cap)-layout slot of each pair, its position counted from
    ``before`` (g, E) (the earlier batch groups' pairs of each dispatch
    group and expert) and then over this group's pairs token-major and
    choice-minor; a position from ``cap`` on drops (slot ``E * gl * cap``).
    Also the group's (g, E) counts of pairs."""
    t, k = idx.shape
    dev = idx.device
    dg = (torch.arange(lo, lo + t, device=dev) // gs)           # (T_l,)
    first = lo // gs
    gl = (lo + t - 1) // gs - first + 1
    local = (dg - first).repeat_interleave(k)                   # (T_l k,)
    pe = idx.reshape(-1)
    key = local * e + pe
    onehot = F.one_hot(key, gl * e).to(torch.int32)
    pos = onehot.cumsum(0).gather(1, key[:, None])[:, 0] - 1
    pos = pos + before[first:first + gl].reshape(-1)[key]
    slot = (pe * gl + local) * cap + pos
    slot = torch.where(pos < cap, slot, e * gl * cap)
    mine = torch.zeros((before.shape[0] * e,), dtype=torch.int64,
                       device=dev).scatter_add_(
        0, (local + first) * e + pe, torch.ones_like(pe))
    return slot.reshape(t, k), gl, mine.reshape(-1, e)


def moe_apply_tp(grp, moes, cfg, h, book: MeshRouting, layer: int,
                 split: bool, shared: str):
    """One batch group's MoE layer, h (B, S, d) on its first device ->
    (out (B, S, d) there, the group's (E,) pair counts, its (E,) sums of
    the router's probabilities: ``book.aux_loss``'s inputs).

    The router runs once, as the group's replicated work, on the global
    dispatch layout: (g, gs, cap) from every batch group's tokens
    (``book.parts`` of them). Where the group holds whole dispatch groups
    its slots are ``dispatch_slots``' over them; else a dispatch group
    spans batch groups, and each pair's position also counts the earlier
    groups' pairs of its dispatch group (an exclusive scan over the data
    axes, ``tensor_parallel.data_scan``). So the ids and the dropped pairs
    are ``moe_apply``'s. ``split``: shard s runs its E / n experts on its
    block of the (E, gl, cap) slots (gathers both ways, ``_MoveRows``)
    and combines its kept pairs in float32; one all-reduce sums the
    shards' partials, in shard order (a regrouping of ``moe_apply``'s
    ascending-expert sum). ``shared``: the shared experts'
    ``swiglu_apply_tp`` mode."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models.layers import swiglu_apply_tp
    b, s, d = h.shape
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    tl = b * s
    part = book.part(grp)
    lo, t = part * tl, tl * book.parts
    g, gs, cap = groups_and_capacity(cfg, t)
    book.tokens[layer] = t
    forced = book.forced_ids(layer, lo, tl, h.device)
    xt = h.reshape(tl, d)

    def route(router):
        w, idx, counts, probs = _route_stats(xt.float() @ router, k, forced)
        return w, idx, counts, probs.sum(0)
    w, idx, counts, psum = grp.local(route, moes[0]["router"])
    if lo % gs == 0 and tl % gs == 0:          # whole dispatch groups
        gl = tl // gs
        slot = grp.local(dispatch_slots, idx, gl, e, cap)
    else:
        before = grp.local(_earlier, [book.counts[(layer, q)]
                                      for q in range(part)], g, e, h.device)
        slot, gl, mine = grp.local(_straddle_slots, idx, lo, gs, e, cap,
                                   before)
        book.counts[(layer, part)] = mine
        grp.local(TP.data_scan, grp.mesh, mine[lo // gs:lo // gs + gl],
                  book.parts)
    n_slots = e * gl * cap
    if _LOG is not None:
        book.log.setdefault(layer, {})[part] = {
            "ids": idx, "counts": torch.bincount(idx.reshape(-1),
                                                 minlength=e),
            "kept": (slot < n_slots).sum(), "pairs": tl * k,
            "slots": e * g * cap, "dropped": slot == n_slots}
    maps = grp.local(_slot_maps, idx, w, slot, n_slots)
    hs = TP.fan_out(grp, h) if split or shared == "tp" else None
    if split:
        per = n_slots // grp.size
        ws = TP.fan_out(grp, maps[1])
        ints = [TP.replicate(grp, m) for m in (maps[0], maps[2], maps[3])]
        routed = TP.all_reduce(grp, [grp.run(
            i, _experts, moes[i], hs[j].reshape(tl, d), ints[0][j],
            ints[1][j], ints[2][j], ws[j], gl * cap, i * per)
            for j, i in enumerate(grp.shards)])
    else:
        slot, w, slot_tok, slot_pair = maps
        routed = grp.local(_experts, moes[0], xt, slot, slot_tok, slot_pair,
                           w, gl * cap)
    out = grp.local(lambda r: r.to(h.dtype).reshape(b, s, d), routed)
    if moes[0]["shared"] is not None:
        out = grp.local(torch.add, out, swiglu_apply_tp(
            grp, [m["shared"] for m in moes], h, shared, hs))
    return out, counts, psum
