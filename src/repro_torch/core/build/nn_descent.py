"""Batched NN-Descent (Dong et al., WWW'11), the reference's
``core/build/nn_descent.py``.

Fixed-shape rounds over one (N, K) neighbor table (ids + squared dists +
the classic new/old "fresh" flag):

  0. *init*: ``init_passes`` random-projection block joins — sort along a
     random direction, join contiguous ``init_bsize`` blocks, one batched
     product each;
  1. *sample*: per row up to ``s_fwd`` fresh and ``s_fwd`` old neighbor
     positions (fresh-first priority sort), plus ``s_rev``-slot reverse
     samples (every edge u->v writes its flat index into a random slot of
     v's fresh/old bucket; the last writer of a slot wins);
  2. *local join*: one (B, Mr, Mc) distance tile per row block (``torch.bmm``
     over gathered rows + precomputed norms); every valid pair proposes
     each end into the other's list;
  3. *update*: proposals fold into an (N, U) slot buffer keyed by a
     per-round salted hash of the proposed id (per-slot minimum, taken by
     one sort per block; a later block replaces a slot only where it is
     strictly nearer), then
     ``kernels/topk_merge``'s merge mode folds buffer + direct row into
     each row's top-K;
  4. rounds stop early once the fraction of changed entries is <= ``delta``.

Randomness. torch cannot reproduce ``jax.random``, so every draw comes
from one ``NNDDraws`` object, in the reference's order: one projection
order per init pass, then one ``RoundDraws`` per round. Without one, the
draws come from a ``torch.Generator``; a parity test passes an object that
makes the reference's own draws.

The duplicate-index scatters and uint32 hashes go through
``build/scatter.py``. Distance-evaluation counts are exact (valid tile
lanes) and summed in int64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.build.scatter import hash_slot, last_writer, \
    nearest_last_writer
from repro_torch.kernels.topk_merge import topk_merge

INF = float("inf")
_SALT_HIGH = 2 ** 31 - 1     # salts are drawn in [0, int32 max), as the ref


class BuildStats(NamedTuple):
    """Work accounting for one kNN-graph build."""
    backend: str
    n: int
    k: int
    distance_evals: int    # pairwise distance evaluations issued
    rounds: int            # refinement rounds actually run (exact: 1)
    update_rate: float     # last round's fraction of changed table entries


class RoundDraws(NamedTuple):
    """The random draws of one ``_round`` (the reference's kf, ko, kr1, kr2
    and kh draws)."""
    pri_new: torch.Tensor   # (N, K) f32 in [0, 1): fresh-first priorities
    pri_old: torch.Tensor   # (N, K) f32 in [0, 1): old-first priorities
    slot_new: torch.Tensor  # (N * K,) int in [0, s_rev): fresh edges' slots
    slot_old: torch.Tensor  # (N * K,) int in [0, s_rev): old edges' slots
    salt: int               # proposal-hash salt in [0, 2**31 - 1)


class NNDDraws:
    """Every random draw of one ``nn_descent`` run, from a generator.

    ``rp_order`` is called once per init pass and ``round`` once per
    refinement round, in that order; a parity test substitutes an object
    with the same two methods that makes the reference's draws.
    """

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def rp_order(self, data: torch.Tensor) -> torch.Tensor:
        """(N,) node ids sorted along a random 1-D projection of ``data``."""
        direction = torch.randn(data.shape[1], generator=self.g,
                                device=self.g.device).to(data.device)
        return torch.sort(data @ direction, stable=True).indices

    def round(self, n: int, k: int, s_rev: int, device) -> RoundDraws:
        g, gd = self.g, self.g.device

        def uniform():
            return torch.rand((n, k), generator=g, device=gd).to(device)

        def slots():
            return torch.randint(0, s_rev, (n * k,), generator=g,
                                 device=gd).to(device)

        pri_new, pri_old = uniform(), uniform()
        slot_new, slot_old = slots(), slots()
        salt = int(torch.randint(0, _SALT_HIGH, (1,), generator=g,
                                 device=gd))
        return RoundDraws(pri_new, pri_old, slot_new, slot_old, salt)


def _fold_merge(ids, dists, fresh, cand_i, cand_d, block):
    """Blockwise ``topk_merge`` (merge mode: the table's old copy of an id
    wins) of per-row candidates with known dists. The merge is per row, so
    the reference's padding of the last block to ``block`` rows changes
    nothing and is skipped."""
    n, k = ids.shape
    parts = [topk_merge(ids[s:s + block], dists[s:s + block],
                        fresh[s:s + block], cand_i[s:s + block],
                        cand_d[s:s + block], k)
             for s in range(0, n, block)]
    return tuple(torch.cat([p[j] for p in parts]) for j in range(3))


def _rp_block_join(order, data, norms, ids, dists, fresh, bsize, block):
    """One random-projection block join (the EFANNA-style init pass).

    ``order`` is the (N,) projection order; it is cut into contiguous
    ``bsize`` blocks, each joined against itself with one (bsize, bsize)
    tile. Returns (ids, dists, fresh, n_evals tensor).
    """
    n, _ = ids.shape
    dev = ids.device
    nb2 = -(-n // bsize)
    pad = nb2 * bsize - n
    order_p = torch.cat([order.to(torch.int32),
                         torch.full((pad,), -1, dtype=torch.int32,
                                    device=dev)]).view(nb2, bsize)
    safe = order_p.clamp_min(0).long()
    vecs = data[safe]                                        # (nb2, bs, D)
    nn = norms[safe]
    t = (nn[:, :, None] + nn[:, None, :]
         - 2.0 * torch.bmm(vecs, vecs.transpose(1, 2))).clamp_min(0.0)
    g_row, g_col = order_p[:, :, None], order_p[:, None, :]
    valid = (g_row >= 0) & (g_col >= 0) & (g_row != g_col)
    ci = torch.where(valid, g_col, -1).view(-1, bsize)
    cd = torch.where(valid, t, INF).view(-1, bsize)
    n_eval = valid.sum(dtype=torch.int64)
    # un-permute: sorted position s belongs to node order_p[s]; padding
    # rows land on the spare row n
    flat = order_p.view(-1)
    tgt = torch.where(flat >= 0, flat, n).long()
    cand_i = torch.full((n + 1, bsize), -1, dtype=torch.int32, device=dev)
    cand_d = torch.full((n + 1, bsize), INF, dtype=torch.float32,
                        device=dev)
    cand_i[tgt] = ci
    cand_d[tgt] = cd
    out = _fold_merge(ids, dists, fresh, cand_i[:n], cand_d[:n], block)
    return out + (n_eval,)


def _seed_dists_chunk(data, norms, rows, init_chunk):
    """(b, I) init ids for ``rows`` -> (ids, dists, n_valid), distances in
    ``data``'s space."""
    init_chunk = init_chunk.to(torch.int32)
    valid = ((init_chunk >= 0) & (init_chunk < data.shape[0])
             & (init_chunk != rows[:, None]))
    safe = torch.where(valid, init_chunk, 0).clamp_min(0).long()
    vecs = data[safe]                                        # (b, I, D)
    q = data[rows.long()]
    d = (norms[rows.long()][:, None] + norms[safe]
         - 2.0 * torch.bmm(vecs, q[:, :, None])[:, :, 0])
    return (torch.where(valid, init_chunk, -1),
            torch.where(valid, d.clamp_min(0.0), INF),
            valid.sum(dtype=torch.int64))


def _seed_from_init(data, norms, ids, dists, fresh, init_ids, block):
    """Fold a caller-supplied (N, I) id table into the empty table.

    Distances are recomputed in *this* data's space (the init table may
    come from another projection: the AntiHub-subset reuse path), one
    evaluation per valid non-self entry, in ``block``-row chunks.
    Returns (ids, dists, fresh, n_evals tensor).
    """
    n = data.shape[0]
    parts = [_seed_dists_chunk(
        data, norms, torch.arange(s, min(s + block, n), dtype=torch.int32,
                                  device=data.device), init_ids[s:s + block])
        for s in range(0, n, block)]
    out = _fold_merge(ids, dists, fresh, torch.cat([p[0] for p in parts]),
                      torch.cat([p[1] for p in parts]), block)
    return out + (torch.stack([p[2] for p in parts]).sum(),)


def _take(pri, ids, fresh, prefer_fresh: bool, count: int):
    """Per row, the ``count`` positions of the stable priority sort: the
    preferred kind first, padding (-1) last."""
    pri = pri + torch.where(fresh == prefer_fresh, 0.0, 1.0)
    pri = torch.where(ids >= 0, pri, 2.0)
    pos = torch.sort(pri, dim=1, stable=True).indices[:, :count]
    return pos, ids.gather(1, pos)


def _rev_sample(v, sel, slot, n, k, slots):
    """(N, slots) reverse samples: every selected edge u->v (flat index
    e = u * k + j) writes e into slot ``slot[e]`` of v, the last writer
    wins; returns the source node u per slot, -1 where none wrote."""
    tgt = torch.where(sel & (v >= 0), v, n).long()
    ptr = last_writer(tgt * slots + slot.long(), (n + 1) * slots)
    ptr = ptr.view(n + 1, slots)[:n]
    return torch.where(ptr >= 0, ptr // k, -1).to(torch.int32)


def _round(draws: RoundDraws, data, norms, ids, dists, fresh, s_fwd, s_rev,
           u_slots, block):
    """One sample -> local-join -> update round.

    Returns (ids, dists, fresh, changed tensor, n_evals tensor).
    """
    n, k = ids.shape
    dev = ids.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)

    # -- sample fresh-first and old-first neighbor positions per row
    pos_new, samp_new = _take(draws.pri_new, ids, fresh, True, s_fwd)
    _, samp_old = _take(draws.pri_old, ids, fresh, False, s_fwd)

    # -- reverse samples into the fresh / old buckets of each target
    v = ids.reshape(-1)
    ef = fresh.reshape(-1)
    rev_new = _rev_sample(v, ef, draws.slot_new, n, k, s_rev)
    rev_old = _rev_sample(v, ~ef, draws.slot_old, n, k, s_rev)
    fresh = fresh.scatter(1, pos_new, False)                 # sampled -> old

    # join sets (new x (new ∪ old)): tile rows are the node + its fresh
    # samples, tile columns add the old samples
    jrows = torch.cat([rows[:, None], samp_new.to(torch.int32), rev_new], 1)
    jcols = torch.cat([jrows, samp_old.to(torch.int32), rev_old], 1)

    # -- local join, block by block; the (N, U) buffer carries the nearest
    # proposal per hash slot, a later block winning only where strictly
    # nearer. A block's winner per slot is its nearest proposal, the last
    # among equals (the reference's scatter-min + winner re-scatter, one
    # sort here); the buffer's spare row n takes the writes that drop.
    spare = n * u_slots
    buf_v = torch.full((spare + u_slots,), -1, dtype=torch.int32,
                       device=dev)
    buf_d = torch.full((spare + u_slots,), INF, dtype=torch.float32,
                       device=dev)
    dir_i, dir_d, n_eval = [], [], []
    for s in range(0, n, block):
        ra, cb = jrows[s:s + block], jcols[s:s + block]      # (B, Mr), (B, Mc)
        sa, sb = ra.clamp_min(0).long(), cb.clamp_min(0).long()
        t = (norms[sa][:, :, None] + norms[sb][:, None, :]
             - 2.0 * torch.bmm(data[sa], data[sb].transpose(1, 2)))
        t = t.clamp_min(0.0)
        a_id = ra[:, :, None].expand(t.shape)
        b_id = cb[:, None, :].expand(t.shape)
        valid = (a_id >= 0) & (b_id >= 0) & (a_id != b_id)
        n_eval.append(valid.sum(dtype=torch.int64))
        # (a) direct: row 0 of the tile is d(self, c) for every column
        dir_i.append(torch.where(valid[:, 0, 1:], cb[:, 1:], -1))
        dir_d.append(torch.where(valid[:, 0, 1:], t[:, 0, 1:], INF))
        # (b) cross proposals, both directions, minus the direct row
        valid = valid.clone()
        valid[:, 0, :] = False
        dd = torch.where(valid, t, INF).reshape(-1)
        dd = torch.cat([dd, dd])
        targ = torch.cat([torch.where(valid, a_id, n).reshape(-1),
                          torch.where(valid, b_id, n).reshape(-1)]).long()
        val = torch.cat([b_id.reshape(-1), a_id.reshape(-1)])
        cell = torch.where(targ < n,
                           targ * u_slots + hash_slot(val, u_slots,
                                                      draws.salt), spare)
        pos, first = nearest_last_writer(cell, dd)
        w_cell, w_d = cell[pos], dd[pos]
        better = first & (w_cell < spare) & (w_d < buf_d[w_cell])
        tgt = torch.where(better, w_cell, spare)
        buf_d[tgt] = w_d
        buf_v[tgt] = val[pos]

    # -- fold direct + proposal candidates into the table (no new dists)
    cat_i = torch.cat([torch.cat(dir_i), buf_v[:spare].view(n, u_slots)], 1)
    cat_d = torch.cat([torch.cat(dir_d), buf_d[:spare].view(n, u_slots)], 1)
    out_i, out_d, out_f = _fold_merge(ids, dists, fresh, cat_i, cat_d, block)
    changed = ((out_i != ids) & (out_i >= 0)).sum()
    return out_i, out_d, out_f, changed, torch.stack(n_eval).sum()


def nn_descent(data: torch.Tensor, k: int, *,
               draws: Optional[NNDDraws] = None, rounds: int = 15,
               delta: float = 0.001,
               s_fwd: int = 5, s_rev: Optional[int] = None,
               u_slots: Optional[int] = None, k_build: Optional[int] = None,
               init_passes: int = 4, init_bsize: int = 32,
               block: int = 2048, init_ids: Optional[torch.Tensor] = None,
               with_stats: bool = False):
    """Approximate (N, k) kNN graph; same contract as ``knn_graph``.

    Returns (dists (N, k) f32 ascending, ids (N, k) int32, self excluded,
    -1/inf padded in the degenerate k >= N case) — plus a ``BuildStats``
    when ``with_stats`` is set.

    ``k_build`` is the internal table width (small requested k runs with a
    wider table, truncated on return). ``init_ids`` (N, I) seeds the table
    from a caller-supplied id table (-1 padded; distances recomputed here).
    ``draws`` supplies every random draw (an ``NNDDraws``, or an object
    with its two methods); default: ``NNDDraws`` over a generator on
    ``data``'s device seeded with 0.
    """
    n = data.shape[0]
    dev = data.device
    if draws is None:
        draws = NNDDraws(torch.Generator(device=dev).manual_seed(0))
    k_build = k_build if k_build is not None else max(k, min(2 * k, 20))
    kk = min(max(k_build, k), n - 1) if n > 1 else 1
    k_out = min(k, n - 1) if n > 1 else 1
    block = min(block, max(n, 1))
    s_fwd = min(s_fwd, kk)
    s_rev = s_rev if s_rev is not None else s_fwd
    u_slots = u_slots if u_slots is not None else max(2 * kk, 16)

    data = data.float().contiguous()
    norms = (data * data).sum(-1)

    ids = torch.full((n, kk), -1, dtype=torch.int32, device=dev)
    dists = torch.full((n, kk), INF, dtype=torch.float32, device=dev)
    fresh = torch.zeros((n, kk), dtype=torch.bool, device=dev)
    evals = []
    if init_ids is not None:
        ids, dists, fresh, n_eval = _seed_from_init(
            data, norms, ids, dists, fresh, init_ids.to(dev), block)
        evals.append(n_eval)
    bsize = min(init_bsize, n)
    for _ in range(init_passes):
        ids, dists, fresh, n_eval = _rp_block_join(
            draws.rp_order(data), data, norms, ids, dists, fresh, bsize,
            block)
        evals.append(n_eval + n)       # tile evals + the projection pass
    rate = 1.0
    r = 0
    for r in range(1, rounds + 1):
        ids, dists, fresh, changed, n_eval = _round(
            draws.round(n, kk, s_rev, dev), data, norms, ids, dists, fresh,
            s_fwd, s_rev, u_slots, block)
        evals.append(n_eval)
        rate = float(changed) / float(n * kk)    # the one host sync a round
        if rate <= delta:
            break

    ids = ids[:, :k_out]
    dists = dists[:, :k_out]
    if k_out < k:                 # degenerate tiny-N case: pad out to k
        padw = k - k_out
        dists = torch.nn.functional.pad(dists, (0, padw), value=INF)
        ids = torch.nn.functional.pad(ids, (0, padw), value=-1)
    if with_stats:
        total = int(torch.stack(evals).sum()) if evals else 0
        return dists, ids, BuildStats(
            backend="nndescent", n=n, k=k, distance_evals=total, rounds=r,
            update_rate=rate)
    return dists, ids
