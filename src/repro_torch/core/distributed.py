"""Sharded graph-index serving + the sharded and out-of-core build tier
(the reference's ``core/distributed.py``).

Scale-out scheme: the database is row-sharded on the mesh's ``model`` axis
(``launch.mesh``); every shard owns an independent NSG sub-graph and entry
points. Queries split over the batch axes and go to every shard; each
shard beam-searches its own sub-graph on its own device, and the per-shard
top-k lists (shards x k wide) merge by the reference's ``lax.top_k`` tie
rule (``distances.smallest_k``: equal distances keep shard order). No
search ever follows an edge across shards.

  * ``ShardedIndex`` — one ``TunedGraphIndex`` fit per shard on the
    shard's device, the serving arrays assembled from per-shard blocks
    (``distributed.sharding.row_sharded_from_blocks``), and a rebuild-free
    ``reprune`` that derives each shard's graph where it lives
    (``build.shardlocal.derive_local``).
  * ``StreamedShardedIndex`` — the single-card host-offload tier: fitted
    shards are parked in pinned host memory (``build.stream
    .HostOffloadStore``) and stream through the card one at a time with
    one-deep prefetch, so N is bounded by host memory, not the card's.
  * ``ShardedFactoryIndex`` — any factory spec row-sharded behind the
    ``Index`` API, with a degraded-search mode (``on_shard_error="skip"``).

The single-controller design is the reference's: one process drives every
shard (a mesh may name one device several times), the per-shard searches
run one after the other, each one ``beam_hops`` launch and one host sync
on the card.

The ANN toggles (``flags``) hold on both graph tiers: ``ANN_BF16_BASE``
stores each shard's rows in bf16, ``ANN_PRENORM`` scores by the distance
over the ``|x|^2`` kept at build time (``base_norms``, of the f32 rows),
and ``ANN_TIGHT_BUDGET`` halves the hop budget.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, fields, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from repro_torch import flags
from repro_torch.core.beam_search import beam_search
from repro_torch.core.build.shardlocal import derive_local
from repro_torch.core.build.stream import HostOffloadStore
from repro_torch.core.device import resolve_device
from repro_torch.core.distances import l2_topk, smallest_k
from repro_torch.core.index_api import build_index
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
from repro_torch.distributed.sharding import (
    RowSharded, columns, put_row_sharded, row_sharded_from_blocks,
    shard_map,
)

INF = float("inf")


def shard_bounds(n: int, s: int) -> np.ndarray:
    """Exact integer row splits: ``bounds[i] = i * n // s`` (s + 1 edges);
    shard sizes differ by at most one row and sum to exactly ``n``."""
    return (np.arange(s + 1, dtype=np.int64) * n) // s


def shard_generator(generator: Optional[torch.Generator],
                    shard: int) -> torch.Generator:
    """Shard ``shard``'s generator, derived from ``generator``'s seed and
    the shard number without drawing from ``generator`` (the reference's
    ``fold_in(key, shard)``): a shard's fit does not depend on which tier
    or mesh fits it."""
    seed = 0 if generator is None else generator.initial_seed()
    return torch.Generator().manual_seed((seed * 1_000_003 + shard)
                                         % 2 ** 63)


def _pad_rows(x: torch.Tensor, m: int, fill=0) -> torch.Tensor:
    """Pad the leading dim up to ``m`` rows with a constant."""
    if x.shape[0] == m:
        return x
    pad = x.new_full((m - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def _sub_stage_stats(sub: TunedGraphIndex) -> dict:
    """One shard's build-stage timings, flattened for bench artifacts."""
    st = sub.build_stats
    return dict(
        n=int(sub.ntotal),
        build_seconds=float(sub.build_seconds),
        knn_seconds=float(sub.knn_seconds),
        pools_seconds=float(getattr(st, "pools_seconds", 0.0)),
        prune_seconds=float(getattr(st, "prune_seconds", 0.0)),
        finish_seconds=float(getattr(st, "interconnect_seconds", 0.0)
                             + getattr(st, "repair_seconds", 0.0)),
        repair_rounds=int(getattr(st, "repair_rounds", 0)),
    )


def device_array_bytes(obj, _depth: int = 3) -> int:
    """Footprint of every array hanging off ``obj`` (a few levels of
    attribute / field nesting deep) — the fallback for index families
    without a ``memory_bytes`` of their own."""
    if hasattr(obj, "nbytes") and hasattr(obj, "dtype"):
        return int(obj.nbytes)
    if _depth <= 0:
        return 0
    if hasattr(obj, "_fields"):                    # NamedTuple
        vals = [getattr(obj, f) for f in obj._fields]
    elif isinstance(obj, dict):
        vals = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        vals = list(obj)
    elif hasattr(obj, "__dict__"):
        vals = list(vars(obj).values())
    else:
        return 0
    return sum(device_array_bytes(v, _depth - 1) for v in vals)


def _merge(d: torch.Tensor, i: torch.Tensor, k: int):
    """(Q, shards*k) lists -> the k best, ties by lower position."""
    nd, pos = smallest_k(d, k)
    return nd, i.gather(1, pos.long())


# ---------------------------------------------------------------------------
# Sharded brute force
# ---------------------------------------------------------------------------


def make_sharded_l2_topk(mesh, k: int, chunk: int = 16384):
    """queries (Q, D) x db (N, D; rows sharded on `model`) -> exact top-k.

    Each shard's exact top-k (``l2_topk``: the l2topk kernel on the card)
    on its own device, ids offset to global ones, then the (Q, shards*k)
    merge. ``db`` is a ``RowSharded`` or a tensor split evenly over the
    shards; ``offsets`` gives each shard's first global id.
    """
    def local(q, db_local, offset):
        d, i = l2_topk(q, db_local, k, chunk=chunk)
        return d, torch.where(i >= 0, i + offset.to(i.dtype), -1)

    def search(queries, db, offsets):
        if not isinstance(db, RowSharded):
            db = put_row_sharded(mesh, torch.as_tensor(db))
        offs = offsets if isinstance(offsets, torch.Tensor) else \
            torch.as_tensor(np.asarray(offsets))
        offs = put_row_sharded(mesh, offs.to(torch.int32))
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            db.blocks[0].device)
        d, i = shard_map(local, mesh, db, offs, batch=q, out="batch")
        return _merge(d, i, k)

    return search


# ---------------------------------------------------------------------------
# Sharded graph index
# ---------------------------------------------------------------------------


@dataclass
class ShardedIndexArrays:
    """Row-sharded serving arrays; rows [s*m:(s+1)*m] belong to shard s."""
    base: RowSharded        # (S*m, D)   projected vectors (padded)
    neighbors: RowSharded   # (S*m, R)   LOCAL ids, -1 padded
    global_ids: RowSharded  # (S*m,)     original database ids (-1 = pad)
    centroids: RowSharded   # (S*C, D)   entry-point centroids per shard
    members: RowSharded     # (S*C,)     LOCAL entry ids (-1 = padded slot)
    pca_mean: torch.Tensor  # (D0,)
    pca_comp: torch.Tensor  # (D0, D)    identity-extended when PCA off
    base_norms: Optional[RowSharded] = None  # (S*m,) |x|^2


def _local_beam(q, base, nbrs, gids, cents, members, norms=None, *,
                ef: int, k: int, max_iters: int, mode: str,
                prenorm: bool = False):
    """One shard's search: nearest-centroid entry -> beam -> global ids.

    The body shared by ``ShardedIndex`` (under ``shard_map``) and the
    streamed tier, so entry-point semantics, prenorm distances and padding
    rules cannot diverge. The beam is ``core.beam_search``: on the card the
    fused hop loop, one ``beam_hops`` launch and one host sync. ``base``
    may hold bf16 rows; ``prenorm`` scores by the distance over ``norms``
    (the rows' |x|^2, computed here from ``base`` when None, as the
    reference's step does).
    """
    qd = q.float()
    cd = ((qd * qd).sum(-1, keepdim=True) + (cents * cents).sum(-1)[None, :]
          - 2.0 * qd @ cents.T)
    # padded entry slots (members == -1) carry a zero centroid; for
    # centered data the origin can beat every real centroid, which would
    # route the query into row 0 of the wrong shard — mask them out
    cd = torch.where((members >= 0)[None, :], cd, INF)
    entry = members[torch.argmin(cd, 1)].clamp_min(0)
    if prenorm and norms is None:
        norms = row_norms(base)
    d, i, _ = beam_search(q, base, nbrs, entry, ef=ef, k=k,
                          max_iters=max_iters or 4 * ef, mode=mode,
                          norms=norms if prenorm else None)
    gi = torch.where(i >= 0, gids[i.clamp_min(0).long()], -1)
    d = torch.where(gi >= 0, d, INF)
    return d, gi


def row_norms(base: torch.Tensor) -> torch.Tensor:
    """(N,) |x|^2 of each row of ``base``, summed in f32."""
    b = base.float()
    return (b * b).sum(-1)


def make_search_step(mesh, *, ef: int, k: int, max_iters: int = 0,
                     mode: str = "fori"):
    """The sharded serve step: fn(queries (Q, D0), arrays) -> (dists (Q, k),
    global ids (Q, k)). ``ANN_TIGHT_BUDGET`` sets ``max_iters = 2 * ef``
    when none is given; ``ANN_PRENORM`` (read here) scores by the prenorm
    distance over ``arrays.base_norms``, or over norms derived from the
    base on each shard when the arrays carry none."""
    if not max_iters and flags.ANN_TIGHT_BUDGET:
        max_iters = 2 * ef
    prenorm = flags.ANN_PRENORM

    def local(q, base, nbrs, gids, cents, members, norms=None):
        return _local_beam(q, base, nbrs, gids, cents, members, norms,
                           ef=ef, k=k, max_iters=max_iters, mode=mode,
                           prenorm=prenorm)

    def step(queries, arrays: ShardedIndexArrays):
        q = (torch.as_tensor(queries, dtype=torch.float32).to(
            arrays.pca_mean.device) - arrays.pca_mean) @ arrays.pca_comp
        norms = (arrays.base_norms,) if prenorm and \
            arrays.base_norms is not None else ()
        d, i = shard_map(local, mesh, arrays.base, arrays.neighbors,
                         arrays.global_ids, arrays.centroids, arrays.members,
                         *norms, batch=q, out="batch")
        return _merge(d, i, k)

    return step


def _base_dtype() -> torch.dtype:
    """The sharded tiers' row type: bf16 under ``ANN_BF16_BASE``."""
    return torch.bfloat16 if flags.ANN_BF16_BASE else torch.float32


def _global_projection(sub: TunedGraphIndex, d0: int, device):
    """Shard 0's (mean, components), or (0, I) with the projection off."""
    if sub.pca is not None:
        return sub.pca.mean.float(), sub.pca.components.float()
    dim = sub.base.shape[1]
    return (torch.zeros(d0, dtype=torch.float32, device=device),
            torch.eye(d0, dim, dtype=torch.float32, device=device))


def _shard_blocks(sub: TunedGraphIndex, *, m: int, c: int, offset: int,
                  mean, comp, base_dt: torch.dtype = torch.float32) -> dict:
    """One fitted shard -> equal-shape blocks (padded to m rows), on the
    shard's device.

    Re-projects the shard's base with the GLOBAL (shard-0) PCA, pads rows
    and centroid slots, and derives the |x|^2 row from the f32 rows before
    the base is cast to ``base_dt`` (bf16 under ``ANN_BF16_BASE``).
    ``members`` pads with -1 (the search masks those entry slots to +inf,
    ``_local_beam``), ``global_ids`` with -1 (those rows are inert).
    """
    dev = sub.base.device
    mean, comp = mean.to(dev), comp.to(dev)
    b = sub.base
    if sub.pca is not None:
        b = (sub.pca.inverse_transform(b) - mean) @ comp
    b = _pad_rows(b.float(), m).contiguous()
    return dict(
        base=b.to(base_dt),
        neighbors=_pad_rows(sub.graph.neighbors.to(torch.int32), m, -1)
        .contiguous(),
        global_ids=_pad_rows(sub.kept_idx.to(torch.int32) + int(offset), m,
                             -1),
        centroids=_pad_rows(sub.eps.centroids.float(), c),
        members=_pad_rows(sub.eps.member_ids.to(torch.int32), c, -1),
        base_norms=row_norms(b),
        knn_ids=_pad_rows(sub.knn_ids.to(torch.int32), m, -1),
        medoid=sub.graph.medoid.to(torch.int32).reshape(1),
    )


class ShardedIndex:
    """Host-orchestrated build of per-shard TunedGraphIndexes + mesh search.

    The per-shard fits are independent (each on the device that owns its
    shard); the search runs every shard on its device and merges. Assembly
    places per-shard device blocks directly and the rebuild-free reprune
    derives shard-locally — no N-proportional array is ever gathered.
    """

    def __init__(self, params: IndexParams, mesh):
        self.params = params
        self.mesh = mesh
        self.arrays: Optional[ShardedIndexArrays] = None
        self._step = None
        # retained per-shard indexes (the reprune below does not use them)
        self.subs: list = []
        self._m = 0                       # per-shard padded row count
        self.n_structural_builds = 0      # per-shard fits ever run here
        # mesh-resident structural substrate for shard-local reprune:
        # the fit-time max-degree adjacency + kNN parents + per-shard
        # medoids (derived clones share these with their parent)
        self.struct_neighbors: Optional[RowSharded] = None
        self.knn_ids: Optional[RowSharded] = None
        self.medoids: Optional[RowSharded] = None

    @property
    def n_shards(self) -> int:
        return self.mesh.shape["model"]

    @property
    def device(self) -> torch.device:
        """Where search results land: the first device of the mesh."""
        return self.mesh.devices.flat[0]

    def fit(self, data, generator: Optional[torch.Generator] = None):
        p = self.params
        n, d0 = data.shape
        s = self.n_shards
        bounds = shard_bounds(n, s)
        owners = columns(self.mesh)[0]
        subs = []
        for i in range(s):
            subs.append(TunedGraphIndex(p, device=owners[i]).fit(
                data[int(bounds[i]):int(bounds[i + 1])],
                shard_generator(generator, i)))
        self.subs = subs
        self.n_structural_builds += s
        m = max(sub.ntotal for sub in subs)
        self._m = m
        # PCA is shard-local in principle; shard 0's projection is
        # broadcast so the query-side transform is global, and every
        # shard's base is re-projected on its device
        mean, comp = _global_projection(subs[0], d0, owners[0])
        blocks = [_shard_blocks(sub, m=m, c=p.ep_clusters,
                                offset=int(bounds[i]), mean=mean, comp=comp,
                                base_dt=_base_dtype())
                  for i, sub in enumerate(subs)]

        def rows(field):
            return row_sharded_from_blocks(self.mesh,
                                           [b[field] for b in blocks])

        self.arrays = ShardedIndexArrays(
            base=rows("base"), neighbors=rows("neighbors"),
            global_ids=rows("global_ids"), centroids=rows("centroids"),
            members=rows("members"),
            pca_mean=mean.to(self.device), pca_comp=comp.to(self.device),
            base_norms=rows("base_norms"))
        self.struct_neighbors = self.arrays.neighbors
        self.knn_ids = rows("knn_ids")
        self.medoids = rows("medoid")
        return self

    # -- rebuild-free derivation ("prune, don't rebuild", sharded) --------
    def reprune(self, *, alpha: float = 1.0,
                degree: Optional[int] = None) -> "ShardedIndex":
        """Derive an (alpha, degree) variant with NO per-shard rebuild:
        each shard re-derives its serving graph from its structural
        (max-degree) adjacency on its own device (``derive_local``: the
        α-scan kernel per 1024-row block, then the repair). Every other
        array is shared with the parent; chained reprunes re-derive from
        the same structural adjacency, and ``n_structural_builds`` is
        inherited unchanged."""
        assert self.arrays is not None, "fit() first"
        rmax = self.struct_neighbors.shape[1]
        r_out = rmax if degree is None else min(degree, rmax)

        def local(base, snbrs, knn, med, gids):
            return derive_local(base, snbrs, knn, med[0], gids >= 0,
                                alpha=alpha, degree=r_out)

        nbrs = shard_map(local, self.mesh, self.arrays.base,
                         self.struct_neighbors, self.knn_ids, self.medoids,
                         self.arrays.global_ids, out="rows")
        out = copy.copy(self)
        out.params = dc_replace(self.params, alpha=alpha,
                                graph_degree=r_out)
        out.arrays = dc_replace(self.arrays, neighbors=nbrs)
        return out

    def search(self, queries, k: int, params=None, *,
               ef: Optional[int] = None, mode: Optional[str] = None):
        if params is not None:
            ef = ef if ef is not None else params.ef_search
            mode = mode if mode is not None else params.mode
        # the toggles the step reads when it is built are part of its key
        skey = (ef or self.params.ef_search, k, mode or "while",
                flags.ANN_PRENORM, flags.ANN_TIGHT_BUDGET)
        if self._step is None or self._step[0] != skey:
            self._step = (skey, make_search_step(
                self.mesh, ef=skey[0], k=k, mode=skey[2]))
        return self._step[1](queries, self.arrays)

    @property
    def shard_stats(self) -> list:
        """Per-shard build-stage timings (knn/pools/prune/finish seconds)
        — what ``launch/tune --bench-build-out`` aggregates."""
        return [_sub_stage_stats(sub) for sub in self.subs]

    @property
    def ntotal(self) -> int:
        if self.arrays is None:
            return 0
        return int(sum(int((b >= 0).sum())
                       for b in self.arrays.global_ids.blocks))

    @property
    def dim(self) -> int:
        return 0 if self.arrays is None else self.arrays.pca_mean.shape[0]

    def search_params_space(self):
        from repro_torch.core.index_api import ef_search_space
        return ef_search_space()

    def memory_bytes(self) -> int:
        """Mesh-resident footprint over the arrays (serving set + the
        structural reprune substrate); arrays a derived clone shares with
        its parent are counted once."""
        if self.arrays is None:
            return 0
        seen, total = set(), 0
        leaves = [getattr(self.arrays, f.name) for f in
                  fields(self.arrays)]
        leaves += [self.struct_neighbors, self.knn_ids, self.medoids]
        for leaf in leaves:
            if leaf is None or id(leaf) in seen:
                continue
            seen.add(id(leaf))
            total += int(leaf.nbytes)
        return total


# ---------------------------------------------------------------------------
# Host-offload tier: build and serve N >> device memory on one card
# ---------------------------------------------------------------------------


class StreamedShardedIndex:
    """Out-of-core single-card tier: shards parked in host memory.

    The same per-shard pipeline as ``ShardedIndex``, but the fitted shards
    are offloaded to a ``HostOffloadStore`` (pinned host memory on CUDA).
    Build, search and reprune stream the shards through the card one at a
    time with one-deep prefetch — device residency is bounded at two
    shards, so N is capped by host memory. Search merges the per-shard
    top-k as ``ShardedIndex`` does (the local step is the same
    ``_local_beam``); reprune runs the same ``derive_local`` shard by shard
    and shares every non-derived host buffer with the parent.
    """

    def __init__(self, params: IndexParams, n_shards: int = 2,
                 device=None):
        self.params = params
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.store = HostOffloadStore(self.device)
        self._structural: Optional[HostOffloadStore] = None
        self.pca_mean: Optional[torch.Tensor] = None
        self.pca_comp: Optional[torch.Tensor] = None
        self._m = 0
        self.input_dim = 0
        self.n_structural_builds = 0
        # per-shard build-stage timings, recorded before each sub is
        # dropped (the sub itself never outlives its offload)
        self.shard_stats: list = []

    def fit(self, data, generator: Optional[torch.Generator] = None):
        p = self.params
        n, d0 = data.shape
        self.input_dim = d0
        bounds = shard_bounds(n, self.n_shards)
        # shard sizes differ by <= 1 row, so m is known up front and each
        # sub can be built, offloaded and dropped before the next starts
        m = -(-n // self.n_shards)
        self._m = m
        for i in range(self.n_shards):
            sub = TunedGraphIndex(p, device=self.device).fit(
                data[int(bounds[i]):int(bounds[i + 1])],
                shard_generator(generator, i))
            self.n_structural_builds += 1
            if i == 0:
                self.pca_mean, self.pca_comp = _global_projection(
                    sub, d0, self.device)
            self.store.offload(i, _shard_blocks(
                sub, m=m, c=p.ep_clusters, offset=int(bounds[i]),
                mean=self.pca_mean, comp=self.pca_comp,
                base_dt=_base_dtype()))
            self.shard_stats.append(_sub_stage_stats(sub))
            del sub             # drop device references -> frees memory
        self._structural = self.store
        return self

    def reprune(self, *, alpha: float = 1.0,
                degree: Optional[int] = None) -> "StreamedShardedIndex":
        """Streamed rebuild-free derivation: fetch a shard, ``derive_local``
        on the card, offload the derived neighbors — every other host
        buffer is shared with the parent."""
        assert self._structural is not None, "fit() first"
        rmax = self._structural.peek_host(0)["neighbors"].shape[1]
        r_out = rmax if degree is None else min(degree, rmax)
        out = copy.copy(self)
        out.store = HostOffloadStore(self.device)
        out.params = dc_replace(self.params, alpha=alpha,
                                graph_degree=r_out)
        self._structural.prefetch(0)
        for i in range(self.n_shards):
            if i + 1 < self.n_shards:
                self._structural.prefetch(i + 1)
            t = self._structural.fetch(i)
            nbrs = derive_local(
                t["base"], t["neighbors"], t["knn_ids"], t["medoid"][0],
                t["global_ids"] >= 0, alpha=alpha, degree=r_out)
            del t
            out.store.offload(i, dict(self._structural.peek_host(i),
                                      neighbors=nbrs))
        return out

    def search(self, queries, k: int, params=None, *,
               ef: Optional[int] = None, mode: Optional[str] = None):
        if params is not None:
            ef = ef if ef is not None else params.ef_search
            mode = mode if mode is not None else params.mode
        ef = ef or self.params.ef_search
        mode = mode or "while"
        max_iters = 2 * ef if flags.ANN_TIGHT_BUDGET else 4 * ef
        q = (torch.as_tensor(queries, dtype=torch.float32).to(self.device)
             - self.pca_mean) @ self.pca_comp
        dists, ids = [], []
        self.store.prefetch(0)
        for i in range(self.n_shards):
            if i + 1 < self.n_shards:
                # stage the NEXT shard's copy before this shard's search
                # is issued, so the copy overlaps the search
                self.store.prefetch(i + 1)
            t = self.store.fetch(i)
            d, gi = _local_beam(q, t["base"], t["neighbors"],
                                t["global_ids"], t["centroids"],
                                t["members"], t.get("base_norms"), ef=ef,
                                k=k, max_iters=max_iters, mode=mode,
                                prenorm=flags.ANN_PRENORM)
            del t               # at most two shards on the card
            dists.append(d)
            ids.append(gi)
        return _merge(torch.cat(dists, 1), torch.cat(ids, 1), k)

    @property
    def ntotal(self) -> int:
        return int(sum(int((self.store.peek_host(key)["global_ids"] >= 0)
                           .sum()) for key in self.store.keys()))

    @property
    def dim(self) -> int:
        return self.input_dim

    def search_params_space(self):
        from repro_torch.core.index_api import ef_search_space
        return ef_search_space()

    def memory_bytes(self) -> int:
        total = self.store.nbytes()
        if self._structural is not None and self._structural is not \
                self.store:
            # derived clone: only the neighbors leaf differs; the shared
            # host buffers are counted once via the structural store
            total = self._structural.nbytes()
            for key in self.store.keys():
                nbrs = self.store.peek_host(key)["neighbors"]
                total += nbrs.numel() * nbrs.element_size()
        if self.pca_mean is not None:
            total += (self.pca_mean.numel() + self.pca_comp.numel()) * 4
        return int(total)


# ---------------------------------------------------------------------------
# Generic sharding over the Index protocol
# ---------------------------------------------------------------------------


class ShardedFactoryIndex:
    """Row-shard ANY registered index family behind the unified API.

    Rows split evenly across ``n_shards``, one independent sub-index per
    shard built from the same factory spec (``build_index``) on
    ``device`` (default: the card); search sends the query batch to every
    sub-index and merges the per-shard top-k lists. A ``PCA<d>`` prefix is
    hoisted out of the per-shard spec and fit ONCE on the full dataset, so
    the shards' distances stay comparable.

    ``on_shard_error="skip"`` is the degraded-search contract: a shard
    whose search raises contributes +inf / -1 lanes, the result is the
    exact top-k over the surviving shards' answers, and the failure is
    counted (``degraded_shards``, ``last_shard_errors``), never hidden.
    """

    def __init__(self, spec: str, n_shards: int = 2,
                 knn_backend: Optional[str] = None,
                 finish_backend: Optional[str] = None,
                 dist_backend: Optional[str] = None,
                 rerank: Optional[int] = None,
                 hop_backend: Optional[str] = None,
                 patience: Optional[int] = None,
                 eps: Optional[float] = None,
                 compact_every: Optional[int] = None,
                 on_shard_error: str = "raise",
                 device=None):
        if on_shard_error not in ("raise", "skip"):
            raise ValueError(
                f"on_shard_error must be 'raise' or 'skip', "
                f"got {on_shard_error!r}")
        self.spec = spec
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.knn_backend = knn_backend         # per-shard build override
        self.finish_backend = finish_backend   # per-shard finish override
        self.dist_backend = dist_backend       # per-shard serving precision
        self.rerank = rerank                   # per-shard exact-rerank depth
        self.hop_backend = hop_backend         # per-shard beam-hop backend
        self.patience = patience               # per-shard adaptive patience
        self.eps = eps                         # per-shard progress threshold
        self.compact_every = compact_every     # per-shard compaction slice
        self.on_shard_error = on_shard_error   # degraded-search default
        self.degraded_shards = 0               # failed shards, last search
        self.last_shard_errors: list = []      # (shard, exception) of same
        self.subs: list = []
        # the max-degree shards fit() built: reprune always derives from
        # these (NOT from self.subs, which on a derived index are already
        # pruned), so chained reprunes never compound
        self._structural_subs: list = []
        self.offsets: Optional[np.ndarray] = None
        self.pca = None
        self.input_dim: int = 0
        self.n_structural_builds = 0     # per-shard fits ever run here

    def _overrides(self) -> dict:
        return dict(knn_backend=self.knn_backend,
                    finish_backend=self.finish_backend,
                    dist_backend=self.dist_backend, rerank=self.rerank,
                    hop_backend=self.hop_backend, patience=self.patience,
                    eps=self.eps, compact_every=self.compact_every)

    def fit(self, data, *, generator: Optional[torch.Generator] = None):
        from repro_torch.core.index_api import split_pca_prefix
        from repro_torch.core.pca import fit_pca
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        self.input_dim = data.shape[1]
        pca_dim, inner_spec = split_pca_prefix(self.spec)
        if pca_dim is not None:
            self.pca = fit_pca(data, pca_dim)
            data = self.pca.transform(data)
        n = data.shape[0]
        bounds = shard_bounds(n, self.n_shards)
        self.offsets = bounds[:-1]
        self.subs = [
            build_index(inner_spec, data[int(bounds[i]):int(bounds[i + 1])],
                        generator=shard_generator(generator, i),
                        device=self.device, **self._overrides())
            for i in range(self.n_shards)]
        self._structural_subs = self.subs
        self.n_structural_builds += self.n_shards
        return self

    def reprune(self, *, alpha: float = 1.0,
                degree: Optional[int] = None) -> "ShardedFactoryIndex":
        """Per-shard rebuild-free (alpha, degree) derivation for specs
        whose family supports ``reprune`` (the NSG pipeline); raises
        TypeError for the others."""
        if not self._structural_subs:
            raise RuntimeError("fit() first")
        if not all(hasattr(s, "reprune") for s in self._structural_subs):
            raise TypeError(
                f"spec {self.spec!r} shards do not support reprune "
                "(graph-family specs only)")
        out = copy.copy(self)
        out.subs = [s.reprune(alpha=alpha, degree=degree)
                    for s in self._structural_subs]
        return out

    def search(self, queries, k: int, params=None, *,
               on_shard_error: Optional[str] = None):
        """Every shard's top-k, merged; ``on_shard_error`` ("raise" |
        "skip", default the constructor's) as in the class docstring."""
        mode = on_shard_error or self.on_shard_error
        if mode not in ("raise", "skip"):
            raise ValueError(
                f"on_shard_error must be 'raise' or 'skip', got {mode!r}")
        queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        if self.pca is not None:
            queries = self.pca.transform(queries)
        nq = queries.shape[0]
        dists, ids = [], []
        self.degraded_shards = 0
        self.last_shard_errors = []
        for shard, (off, sub) in enumerate(zip(self.offsets, self.subs)):
            try:
                d, i = sub.search(queries, k, params)
            except Exception as e:
                if mode == "raise":
                    raise
                self.degraded_shards += 1
                self.last_shard_errors.append((shard, e))
                d = torch.full((nq, k), INF, device=self.device)
                i = torch.full((nq, k), -1, dtype=torch.int32,
                               device=self.device)
            i = i.to(torch.int32)
            dists.append(d.float())
            ids.append(torch.where(i >= 0, i + int(off), -1))
        if self.degraded_shards == len(self.subs):
            raise RuntimeError(
                f"all {len(self.subs)} shards failed; no degraded result "
                f"is possible (first: {self.last_shard_errors[0][1]!r})")
        d = torch.cat(dists, 1)                      # (Q, shards*k)
        i = torch.cat(ids, 1)
        d = torch.where(i >= 0, d, INF)
        return _merge(d, i, k)

    @property
    def ntotal(self) -> int:
        return sum(s.ntotal for s in self.subs)

    @property
    def dim(self) -> int:
        return self.input_dim

    def search_params_space(self):
        # all shards share a spec, hence a knob space; pre-fit, derive it
        # from the spec like every other conformer does
        if self.subs:
            return self.subs[0].search_params_space()
        from repro_torch.core.index_api import parse_spec
        _, unfitted = parse_spec(self.spec, max(self.input_dim, 1),
                                 device=self.device)
        return unfitted.search_params_space()

    def memory_bytes(self) -> int:
        """Per-shard footprints + the hoisted PCA; a sub without
        ``memory_bytes`` is counted over its arrays (``device_array_bytes``)
        instead of as 0."""
        total = 0
        for s in self.subs:
            fn = getattr(s, "memory_bytes", None)
            total += int(fn()) if callable(fn) else device_array_bytes(s)
        if self.pca is not None:
            total += (self.pca.components.numel()
                      + self.pca.mean.numel()) * 4
        return total

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        """The reference's layout: each shard's arrays under ``sub<i>/``,
        so either package loads the other's sharded snapshot."""
        from repro_torch.core.persist import index_state
        arrays: dict = {"offsets": np.asarray(self.offsets, np.int64)}
        subs_meta = []
        for si, sub in enumerate(self.subs):
            st = index_state(sub)
            subs_meta.append({"family": st["family"], "meta": st["meta"]})
            arrays.update({f"sub{si}/{k}": v
                           for k, v in st["arrays"].items()})
        if self.pca is not None:
            arrays["pca_mean"] = self.pca.mean.cpu().numpy()
            arrays["pca_components"] = self.pca.components.cpu().numpy()
            arrays["pca_explained"] = self.pca.explained.cpu().numpy()
        meta = {"spec": self.spec, "n_shards": self.n_shards,
                "input_dim": self.input_dim,
                "on_shard_error": self.on_shard_error,
                "overrides": self._overrides(),
                "subs": subs_meta}
        return {"meta": meta, "arrays": arrays}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "ShardedFactoryIndex":
        from repro_torch.core.index_api import split_pca_prefix
        from repro_torch.core.pca import PCA
        from repro_torch.core.persist import index_from_state
        meta, a = state["meta"], state["arrays"]
        idx = cls(meta["spec"], n_shards=meta["n_shards"],
                  on_shard_error=meta.get("on_shard_error", "raise"),
                  device=device, **meta["overrides"])
        dev = idx.device
        t = lambda name: torch.from_numpy(np.array(a[name])).to(dev)
        idx.input_dim = int(meta["input_dim"])
        idx.offsets = np.asarray(a["offsets"])
        if "pca_mean" in a:
            idx.pca = PCA(mean=t("pca_mean").float(),
                          components=t("pca_components").float(),
                          explained=t("pca_explained").float())
        _, inner_spec = split_pca_prefix(meta["spec"])
        idx.subs = []
        for si, sub_meta in enumerate(meta["subs"]):
            sub = index_from_state({
                "family": sub_meta["family"], "meta": sub_meta["meta"],
                "arrays": {k[len(f"sub{si}/"):]: v for k, v in a.items()
                           if k.startswith(f"sub{si}/")}}, device=dev)
            sub.spec = inner_spec
            idx.subs.append(sub)
        idx._structural_subs = idx.subs
        return idx



def input_specs_for_search(cfg, batch: int, n_candidates: int,
                           n_shards: int, device="meta") -> dict:
    """The ANN serve step's inputs as tensors on ``device`` (meta: shapes
    and dtypes, nothing allocated, the port's counterpart of the
    reference's ``ShapeDtypeStruct``s): the queries and a
    ``ShardedIndexArrays`` of flat (unsharded) tensors, the base in bf16
    under ``ANN_BF16_BASE``."""
    dim = cfg.pca_dim
    m = -(-n_candidates // n_shards)
    n_rows = n_shards * m
    f32, i32 = torch.float32, torch.int32
    base_dt = torch.bfloat16 if flags.ANN_BF16_BASE else f32
    sd = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
    return dict(
        queries=sd((batch, cfg.dim), f32),
        arrays=ShardedIndexArrays(
            base=sd((n_rows, dim), base_dt),
            neighbors=sd((n_rows, cfg.graph_degree), i32),
            global_ids=sd((n_rows,), i32),
            centroids=sd((n_shards * cfg.ep_clusters, dim), f32),
            members=sd((n_shards * cfg.ep_clusters,), i32),
            pca_mean=sd((cfg.dim,), f32),
            pca_comp=sd((cfg.dim, dim), f32),
            base_norms=sd((n_rows,), f32),
        ),
    )
