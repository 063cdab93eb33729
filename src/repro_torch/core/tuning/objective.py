"""The ANN tuning objective (paper Eq. 1-3): measure QPS + Recall@k for a
parameter assignment (the reference's ``core/tuning/objective.py``).

Builds are cached by the *structural* sub-key (pca_dim, antihub_keep,
kNN/candidate build params), and the cached build is made once at the
structural maximum (base graph_degree, pruning alpha=1 — the densest member
of the α-reachable family). At that moment the whole (alpha, degree)
reprune grid is computed in one pass over the shared sorted max-degree
adjacency (``build.prune.reprune_family``, ``materialize=False``: packed
survivor bitmasks) and reconstructed lazily per trial, so trials that move:

  * ``graph_degree`` / ``alpha``  — snap alpha to the grid and look up
    their adjacency (a member of the family + connectivity repair; no
    prune pass, no candidate pools, no rebuild; ``grid_hits`` counts these
    lookups);
  * ``ep_clusters``               — re-fit entry points on the cached base
    (cached per (structure, k));
  * ``ef_search``, ``hop_backend``, ``patience`` — re-run search only.

So the only knobs that force a real rebuild are the paper's D (pca_dim) and
AntiHub alpha (antihub_keep) — and the raw database's kNN table feeding the
AntiHub pass is computed once and threaded through every fit.

Every exact kNN pass here (the ground truth, the AntiHub table, each
build's kNN table, k-means and the entry-point select) runs through
``core.distances.l2_topk``: the ``l2topk`` kernel on the card.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.build import (
    build_knn, nsg_from_neighbors, reprune_family, resolve_finish_backend,
)
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.entry_points import fit_entry_points
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex, fold_in
from repro_torch.core.quant import make_codec
from repro_torch.core.tuning.space import Categorical, Float, Int, SearchSpace
from repro_torch.core.tuning.study import Trial


# The precomputed pruning-alpha grid of the rebuild-free objective: 0.05
# pitch over default_space's [1.0, 1.4] range. Sampled alphas snap to it.
DEFAULT_ALPHA_GRID = tuple(round(1.0 + 0.05 * i, 2) for i in range(9))


def snap_alpha(grid: Tuple[float, ...], alpha: float) -> Tuple[int, float]:
    """Nearest grid point (index, value) for a sampled pruning alpha."""
    i = int(np.argmin([abs(a - alpha) for a in grid]))
    return i, grid[i]


def default_space(dim: int, n: int, max_degree: int = 32,
                  quantized: bool = False) -> SearchSpace:
    """The paper's knobs (D, alpha, k, ef) + the two rebuild-free graph
    knobs the reprune path makes cheap (graph_degree, pruning alpha), and
    the serving knobs ``hop_backend`` and ``patience`` (0 = off).

    ``max_degree`` must match the objective's structural ceiling (its base
    ``graph_degree``); sampled degrees above it are clamped.
    ``quantized=True`` adds ``dist_backend`` (f32 | pq | int8) and the
    exact-rerank depth ``rerank``.
    """
    space = (SearchSpace()
             .add("pca_dim", Int(max(8, dim // 4), dim))
             .add("antihub_keep", Float(0.7, 1.0))
             .add("graph_degree", Int(max(4, max_degree // 4), max_degree))
             .add("alpha", Float(1.0, 1.4))
             .add("ep_clusters", Int(1, max(2, min(256, n // 20)), log=True))
             .add("ef_search", Int(16, 256, log=True))
             .add("hop_backend", Categorical(("staged", "fused")))
             .add("patience", Int(0, 16)))
    if quantized:
        space = (space
                 .add("dist_backend", Categorical(("f32", "pq", "int8")))
                 .add("rerank", Int(8, 128, log=True)))
    return space


@dataclass
class EvalResult:
    recall: float
    qps: float
    build_seconds: float
    mem_bytes: int
    cached_build: bool       # True: no structural build ran for this trial
    repruned: bool = False   # True: graph derived via reprune (not rebuilt)


class AnnObjective:
    """Callable objective with build caching + QPS measurement.

    ``qps_repeats`` timed searches follow one warm-up; QPS is the query
    count over their median, each timed to the device's completion.
    ``base_params.graph_degree`` is the structural ceiling: the one real
    build per structure happens at that degree with pruning alpha=1, and
    every (graph_degree, alpha) trial is derived from it.

    ``seed`` seeds every random draw (k-means++ of the entry points and of
    PQ codebooks, NN-Descent's draws through ``fold_in``): each draw starts
    from a fresh CPU generator seeded with it, as the reference reuses one
    key. ``device`` defaults to the card.
    """

    def __init__(self, data, queries, k: int = 10,
                 base_params: Optional[IndexParams] = None,
                 recall_floor: float = 0.9, qps_repeats: int = 5,
                 mem_limit_bytes: Optional[int] = None, seed: int = 0,
                 alpha_grid: Optional[Tuple[float, ...]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.data = torch.as_tensor(data, dtype=torch.float32).to(
            self.device)
        self.queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        self.k = k
        self.recall_floor = recall_floor
        self.qps_repeats = qps_repeats
        self.mem_limit = mem_limit_bytes
        self.seed = seed
        self.base = base_params or IndexParams(pca_dim=self.data.shape[1])
        resolve_finish_backend(self.base.finish_backend)   # validate
        self.max_degree = self.base.graph_degree
        self.alpha_grid = tuple(sorted(
            alpha_grid if alpha_grid is not None else DEFAULT_ALPHA_GRID))
        _, self.true_i = FlatIndex(self.data).search(self.queries, k)
        self._build_cache: Dict[tuple, TunedGraphIndex] = {}
        self._family_cache: Dict[tuple, object] = {}   # skey -> RepruneFamily
        self._graph_cache: Dict[tuple, object] = {}
        self._ep_cache: Dict[tuple, object] = {}
        # skey + (dist_backend, pq_m) -> (codec, codes): one codec training
        # + encode per structure/backend; reprune trials share the codes
        self._codec_cache: Dict[tuple, tuple] = {}
        self._antihub_ids = None
        self.eval_log: list = []
        self.grid_hits = 0         # repruned trials served by a grid lookup
        self.family_prunes = 0     # family passes (1 per structure)

    # -- internals ---------------------------------------------------------
    def _generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed)

    def _structural_key(self, p: IndexParams) -> tuple:
        return (p.pca_dim, round(p.antihub_keep, 4), p.build_knn_k,
                p.build_candidates, p.knn_backend)

    def _antihub_knn_ids(self, p: IndexParams):
        """The raw database's kNN table for AntiHub — computed once ever."""
        if self._antihub_ids is None:
            _, self._antihub_ids = build_knn(
                self.data, 10, backend=p.knn_backend,
                draws=fold_in(self._generator(), 17, self.device))
        return self._antihub_ids

    def _snap_alpha(self, alpha: float) -> Tuple[int, float]:
        return snap_alpha(self.alpha_grid, alpha)

    def _get_index(self, p: IndexParams) -> Tuple[TunedGraphIndex, bool,
                                                  bool]:
        skey = self._structural_key(p)
        if skey in self._build_cache:
            full = self._build_cache[skey]
            cached = True
        else:
            # structural builds are always f32: codecs are trained lazily
            # per (structure, dist_backend, pq_m) below and attached to
            # the derived serving copies, never baked into the cache
            structural = replace(p, ep_clusters=1, alpha=1.0,
                                 graph_degree=self.max_degree,
                                 dist_backend="f32")
            ah_ids = (self._antihub_knn_ids(p)
                      if p.antihub_keep < 1.0 else None)
            full = TunedGraphIndex(structural, device=self.device).fit(
                self.data, self._generator(), antihub_knn_ids=ah_ids)
            self._build_cache[skey] = full
            # the whole (alpha, degree) family in one pass over the
            # just-built max-degree graph, kept as packed bitmasks
            self._family_cache[skey] = reprune_family(
                full.base, full.graph.neighbors, self.alpha_grid,
                materialize=False)
            self.family_prunes += 1
            # the build already fit the ep_clusters=1 selector
            self._ep_cache[skey + (1,)] = full.eps
            cached = False

        degree = min(p.graph_degree, self.max_degree)
        a_idx, alpha = self._snap_alpha(float(p.alpha))
        repruned = (degree != self.max_degree) or (alpha != 1.0)
        if repruned:
            gkey = skey + (degree, alpha)
            if gkey not in self._graph_cache:
                fam = self._family_cache[skey]
                self._graph_cache[gkey] = nsg_from_neighbors(
                    full.base, fam.member(a_idx, degree),
                    full.graph.medoid, knn_ids=full.knn_ids,
                    finish_backend=self.base.finish_backend)
            self.grid_hits += 1
            idx = full.with_graph(self._graph_cache[gkey])
        else:
            idx = full.with_graph(full.graph)

        ekey = skey + (p.ep_clusters,)
        if ekey not in self._ep_cache:
            self._ep_cache[ekey] = fit_entry_points(
                self._generator(), idx.base, p.ep_clusters)
        idx.eps = self._ep_cache[ekey]

        if p.dist_backend != "f32":
            ckey = skey + (p.dist_backend, p.pq_m)
            if ckey not in self._codec_cache:
                codec = make_codec(p.dist_backend, full.base.shape[1],
                                   p.pq_m)
                codec.fit(full.base, generator=self._generator())
                self._codec_cache[ckey] = (codec,
                                           codec.encode(full.base)
                                           .contiguous())
            idx.codec, idx.codes = self._codec_cache[ckey]
            idx.codec_backend = p.dist_backend
        return idx, cached, repruned

    def evaluate(self, params: Dict) -> EvalResult:
        params = dict(params)
        if params.get("graph_degree", 0) > self.max_degree:
            # keep the log honest: record the degree actually evaluated
            warnings.warn(
                f"graph_degree={params['graph_degree']} exceeds the "
                f"structural ceiling {self.max_degree} (base graph_degree);"
                f" clamping — pass max_degree={self.max_degree} to "
                f"default_space to avoid sampling a dead range",
                RuntimeWarning, stacklevel=2)
            params["graph_degree"] = self.max_degree
        if "alpha" in params:
            # keep the log honest: record the grid point actually served
            params["alpha"] = self._snap_alpha(float(params["alpha"]))[1]
        p = replace(self.base, **params)
        t0 = time.perf_counter()
        idx, cached, repruned = self._get_index(p)
        synchronize(self.device)
        build_s = time.perf_counter() - t0
        ef = max(p.ef_search, self.k)
        kw = dict(ef=ef, dist_backend=p.dist_backend, rerank=p.rerank,
                  hop_backend=p.hop_backend, patience=p.patience, eps=p.eps,
                  compact_every=p.compact_every)
        _, i = idx.search(self.queries, self.k, **kw)         # warm-up
        synchronize(self.device)
        times = []
        for _ in range(self.qps_repeats):
            t1 = time.perf_counter()
            _, i = idx.search(self.queries, self.k, **kw)
            synchronize(self.device)
            times.append(time.perf_counter() - t1)
        qps = self.queries.shape[0] / float(np.median(times))
        rec = recall_at_k(i, self.true_i)
        res = EvalResult(recall=rec, qps=qps, build_seconds=build_s,
                         mem_bytes=idx.memory_bytes(), cached_build=cached,
                         repruned=repruned)
        self.eval_log.append((dict(params), res))
        return res

    # -- objective forms (paper Eqs. 1-2 and 3) ------------------------------
    def single_objective(self, trial: Trial) -> dict:
        """maximize QPS  s.t.  Recall@k >= floor (and optional memory cap)."""
        r = self.evaluate(trial.params)
        cons = [self.recall_floor - r.recall]
        if self.mem_limit:
            cons.append((r.mem_bytes - self.mem_limit) / self.mem_limit)
        trial.user_attrs["result"] = r
        return {"values": r.qps, "constraints": cons}

    def multi_objective(self, trial: Trial) -> dict:
        """maximize (QPS, Recall@k)."""
        r = self.evaluate(trial.params)
        cons = []
        if self.mem_limit:
            cons.append((r.mem_bytes - self.mem_limit) / self.mem_limit)
        trial.user_attrs["result"] = r
        return {"values": (r.qps, r.recall), "constraints": cons}


class SearchParamsObjective:
    """Index-agnostic runtime tuning: optimize ``SearchParams`` for ANY
    ``core.index_api.Index`` conformer, with zero index-specific branches.

    The search space comes from ``index.search_params_space()`` (each
    family declares its own knobs — nprobe for IVF, ef_search for graphs);
    a trial's params become one ``SearchParams``, and the same evaluate
    path measures recall + QPS whatever is behind the interface. Pass a
    built index or a factory spec string ("IVF64", "PCA16,HNSW32", ...),
    which ``build_index`` fits on ``device`` (default: the card) with
    ``generator``. QPS is timed on the host clock around a device
    synchronize, as the reference's around ``block_until_ready``.
    """

    def __init__(self, index, data, queries, k: int = 10,
                 recall_floor: float = 0.9, qps_repeats: int = 3,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        from repro_torch.core.index_api import build_index
        if isinstance(index, str):
            index = build_index(index, data, generator=generator,
                                device=device)
        self.index = index
        dev = getattr(index, "device", None)
        self.device = dev if dev is not None else resolve_device(device)
        self.queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        self.k = k
        self.recall_floor = recall_floor
        self.qps_repeats = qps_repeats
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        _, self.true_i = FlatIndex(data).search(self.queries, k)
        self.eval_log: list = []

    @property
    def space(self) -> SearchSpace:
        return self.index.search_params_space()

    def evaluate(self, params: Dict) -> EvalResult:
        from repro_torch.core.index_api import SearchParams
        sp = SearchParams(**params)
        self.index.search(self.queries, self.k, sp)          # warmup
        synchronize(self.device)
        times = []
        for _ in range(self.qps_repeats):
            t1 = time.perf_counter()
            d, i = self.index.search(self.queries, self.k, sp)
            synchronize(self.device)
            times.append(time.perf_counter() - t1)
        qps = self.queries.shape[0] / float(np.median(times))
        mem = getattr(self.index, "memory_bytes", None)
        res = EvalResult(recall=recall_at_k(i, self.true_i), qps=qps,
                         build_seconds=0.0, mem_bytes=mem() if mem else 0,
                         cached_build=True)
        self.eval_log.append((dict(params), res))
        return res

    def single_objective(self, trial: Trial) -> dict:
        """maximize QPS  s.t.  Recall@k >= floor."""
        r = self.evaluate(trial.params)
        trial.user_attrs["result"] = r
        return {"values": r.qps,
                "constraints": [self.recall_floor - r.recall]}

    def multi_objective(self, trial: Trial) -> dict:
        """maximize (QPS, Recall@k)."""
        r = self.evaluate(trial.params)
        trial.user_attrs["result"] = r
        return {"values": (r.qps, r.recall)}


class ShardedRepruneObjective:
    """(graph_degree, alpha, ef_search) sweeps on a *sharded* index with
    exactly one structural build per shard.

    ``index`` is a fitted ``ShardedIndex`` / ``StreamedShardedIndex`` /
    ``ShardedFactoryIndex`` (any conformer exposing ``reprune(alpha=,
    degree=)``) built at the structural maximum; every trial derives its
    serving graphs per shard from the cached max-degree graphs — the
    "prune, don't rebuild" property at cluster scale. Derived indexes are
    cached per snapped (degree, alpha), so a sweep is one reprune per
    distinct grid point and zero rebuilds (``grid_hits`` and the pipeline's
    structural-build counter make that assertable). QPS is timed on the
    host clock around a device synchronize.
    """

    def __init__(self, index, data, queries, k: int = 10,
                 recall_floor: float = 0.9, qps_repeats: int = 3,
                 alpha_grid: Optional[Tuple[float, ...]] = None):
        if not hasattr(index, "reprune"):
            raise TypeError(
                f"{type(index).__name__} has no reprune(); sharded "
                "degree/alpha sweeps need a graph family (NSG specs)")
        self.index = index
        self.device = index.device
        self.queries = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device)
        self.k = k
        self.recall_floor = recall_floor
        self.qps_repeats = qps_repeats
        # the structural ceiling: the degree the shards were built at
        # (the sharded indexes carry params themselves; the factory
        # wrapper's live on its per-shard sub-indexes)
        p = getattr(index, "params", None)
        if p is None and getattr(index, "subs", None):
            p = getattr(index.subs[0], "params", None)
        self.max_degree = p.graph_degree if p is not None else None
        self.alpha_grid = tuple(sorted(
            alpha_grid if alpha_grid is not None else DEFAULT_ALPHA_GRID))
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        _, self.true_i = FlatIndex(data).search(self.queries, k)
        self._cache: Dict[tuple, object] = {}
        self.grid_hits = 0
        self.reprunes = 0
        self.eval_log: list = []

    @property
    def space(self) -> SearchSpace:
        from repro_torch.core.index_api import ef_search_space
        md = self.max_degree or 32
        return (ef_search_space()
                .add("graph_degree", Int(max(4, md // 4), md))
                .add("alpha", Float(self.alpha_grid[0],
                                    self.alpha_grid[-1])))

    def _derived(self, degree: int, alpha: float):
        _, a = snap_alpha(self.alpha_grid, alpha)
        if self.max_degree is not None:
            degree = min(degree, self.max_degree)
            if degree == self.max_degree and a == 1.0:
                return self.index, a       # the cached structural maximum
        key = (degree, a)
        if key not in self._cache:
            self._cache[key] = self.index.reprune(alpha=a, degree=degree)
            self.reprunes += 1
        else:
            self.grid_hits += 1
        return self._cache[key], a

    def evaluate(self, params: Dict) -> EvalResult:
        from repro_torch.core.index_api import SearchParams
        params = dict(params)
        idx, a = self._derived(int(params.get("graph_degree",
                                              self.max_degree or 32)),
                               float(params.get("alpha", 1.0)))
        params["alpha"] = a
        sp = SearchParams(ef_search=max(
            int(params.get("ef_search", 64)), self.k))
        idx.search(self.queries, self.k, sp)                 # warmup
        synchronize(self.device)
        times = []
        for _ in range(self.qps_repeats):
            t1 = time.perf_counter()
            d, i = idx.search(self.queries, self.k, sp)
            synchronize(self.device)
            times.append(time.perf_counter() - t1)
        qps = self.queries.shape[0] / float(np.median(times))
        mem = getattr(idx, "memory_bytes", None)
        res = EvalResult(recall=recall_at_k(i, self.true_i), qps=qps,
                         build_seconds=0.0, mem_bytes=mem() if mem else 0,
                         cached_build=True, repruned=True)
        self.eval_log.append((params, res))
        return res

    def single_objective(self, trial: Trial) -> dict:
        r = self.evaluate(trial.params)
        trial.user_attrs["result"] = r
        return {"values": r.qps,
                "constraints": [self.recall_floor - r.recall]}

    def multi_objective(self, trial: Trial) -> dict:
        r = self.evaluate(trial.params)
        trial.user_attrs["result"] = r
        return {"values": (r.qps, r.recall)}
