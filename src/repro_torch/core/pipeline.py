"""The paper's end-to-end pipeline (Fig. 2): AntiHub subsample -> PCA ->
NSG build -> k-means entry points; search = project -> select EP -> beam.

``IndexParams`` carries every knob of the reference's, so a reference
state's ``meta["params"]`` loads as is. The port builds with either kNN
backend (exact or NN-Descent, with the AntiHub-subset reuse of the raw
table), either pools backend (beam search or table-derived) and either
finishing pass (device or host), serves in f32 or quantized (pq | int8 LUT
traversal with an exact f32 rerank), with or without adaptive termination
(``patience``/``eps``) and with or without active-query compaction
(``compact_every``), and derives lower-degree or larger-alpha graphs
without a rebuild (``reprune``, ``with_graph``).
"""
from __future__ import annotations

import copy
import time
from dataclasses import asdict, dataclass, replace
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ANNConfig
from repro_torch.core import antihub as antihub_mod
from repro_torch.core.beam_search import BeamStats, beam_search, \
    beam_search_compacted
from repro_torch.core.build import build_knn, reprune_nsg, resolve_backend
from repro_torch.core.build.nn_descent import NNDDraws, nn_descent
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.distances import smallest_k
from repro_torch.core.entry_points import EntryPointSelector, fit_entry_points
from repro_torch.core.nsg import NSGGraph, build_nsg
from repro_torch.core.pca import PCA, fit_pca
from repro_torch.core.quant import Int8Codec, PQCodec, check_dist_backend, \
    make_codec
from repro_torch.kernels.gather_dist import gather_dist

# Process-wide structural-build counter: every TunedGraphIndex.fit (a real
# graph build: pools + prune + finish) adds one. Rebuild-free derivations
# (reprune, with_graph, the tuner's grid lookups) do not, so a test can
# assert that a sweep left it untouched.
_N_STRUCTURAL_BUILDS = 0

# NN-Descent refinement rounds for the AntiHub-subset reuse path: the
# filtered raw-data table is already a good approximation, so a few patch
# rounds replace a from-scratch build.
SUBSET_PATCH_ROUNDS = 3


def fold_in(generator: torch.Generator, data: int, device) -> NNDDraws:
    """NN-Descent's draws for one seeded step: a generator on ``device``
    derived from ``generator``'s seed and ``data`` without drawing from
    ``generator`` (the counterpart of the reference's
    ``jax.random.fold_in(key, data)``: the step moves no other draw of the
    fit)."""
    return NNDDraws(torch.Generator(device=device).manual_seed(
        (generator.initial_seed() * 1_000_003 + data) % 2 ** 63))


def structural_build_count() -> int:
    """Process-wide count of real (non-derived) NSG pipeline builds."""
    return _N_STRUCTURAL_BUILDS


@dataclass(frozen=True)
class IndexParams:
    pca_dim: int                  # D   (== input dim -> PCA disabled)
    antihub_keep: float = 1.0     # alpha (1.0 -> subsampling disabled)
    ep_clusters: int = 1          # k    (1 -> medoid, vanilla NSG)
    ef_search: int = 64
    graph_degree: int = 32
    build_knn_k: int = 32
    build_candidates: int = 64
    alpha: float = 1.0            # α-RNG pruning slack (1.0 = MRNG)
    knn_backend: str = "auto"     # "exact" | "nndescent" | "auto"
    pools_backend: str = "auto"   # "search" | "nndescent" | "auto"
    finish_backend: str = "auto"  # "host" | "device" | "auto"
    dist_backend: str = "f32"     # "f32" | "pq" | "int8"
    pq_m: int = 0
    rerank: int = 64
    hop_backend: str = "auto"     # "staged" | "fused" | "auto"
    patience: int = 0
    eps: float = 0.0
    compact_every: int = 0

    @staticmethod
    def from_config(cfg: ANNConfig, **overrides) -> "IndexParams":
        p = dict(
            pca_dim=cfg.pca_dim, antihub_keep=cfg.antihub_keep,
            ep_clusters=cfg.ep_clusters, ef_search=cfg.ef_search,
            graph_degree=cfg.graph_degree, build_knn_k=cfg.build_knn_k,
            build_candidates=cfg.build_candidates, alpha=cfg.prune_alpha,
            knn_backend=cfg.knn_backend, finish_backend=cfg.finish_backend,
            dist_backend=cfg.dist_backend, pq_m=cfg.pq_m,
            rerank=cfg.rerank, hop_backend=cfg.hop_backend,
            patience=cfg.patience, eps=cfg.eps,
            compact_every=cfg.compact_every)
        p.update(overrides)
        return IndexParams(**p)


class TunedGraphIndex:
    """antihub ∘ pca ∘ nsg ∘ entry-points, searchable. Fit is build-time."""

    def __init__(self, params: IndexParams, device=None):
        self.params = params
        self.device = resolve_device(device)
        self.kept_idx: Optional[torch.Tensor] = None  # internal -> original
        self.pca: Optional[PCA] = None
        self.base: Optional[torch.Tensor] = None      # projected kept vectors
        self.graph: Optional[NSGGraph] = None
        self.eps: Optional[EntryPointSelector] = None
        self.build_seconds: float = 0.0
        self.knn_seconds: float = 0.0                 # kNN-graph phase
        self.stage_seconds: dict = {}                 # per build stage
        self.knn_stats: dict = {}                     # BuildStats per table
        self.build_stats = None                       # NSGBuildStats of fit
        self.input_dim: int = 0
        self.knn_ids: Optional[torch.Tensor] = None   # build-time kNN table
        self.codec = None                             # core.quant codec
        self.codes: Optional[torch.Tensor] = None     # (N, M) uint8 db codes
        self.codec_backend: Optional[str] = None      # "pq" | "int8"
        self.quantize_seconds: dict = {}              # codec fit / encode
        self.last_search_stats: Optional[BeamStats] = None
        self.last_compaction_shapes: Optional[list] = None
        self.spec: Optional[str] = None               # factory spec, if any

    # -- build ------------------------------------------------------------
    def fit(self, data, generator: Optional[torch.Generator] = None, *,
            antihub_knn_ids: Optional[torch.Tensor] = None):
        """Build the full pipeline; ``generator`` draws the k-means++ inits
        of the entry points and, under a quantized ``dist_backend``, of the
        PQ codebooks (default: a CPU generator seeded with 0). NN-Descent's
        draws come from generators derived from its seed (``fold_in`` 17
        for the AntiHub table, 23 for the structural one, as the
        reference's keys), so they move no other draw.

        ``antihub_knn_ids``: precomputed (N, >=10) kNN ids of the *raw*
        database, reused for the AntiHub k-occurrence pass (the tuner
        computes them once and threads them through every structural
        build) and, under NN-Descent, to seed the subset's table.
        """
        global _N_STRUCTURAL_BUILDS
        p = self.params
        check_dist_backend(p.dist_backend)
        dev = self.device
        generator = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        t0 = time.perf_counter()
        stages = {}
        self.knn_stats = {}
        data = torch.as_tensor(data, dtype=torch.float32).to(dev)
        n, d0 = data.shape
        self.input_dim = d0

        t = time.perf_counter()
        ah_ids = None
        if p.antihub_keep < 1.0:
            if antihub_knn_ids is None:
                _, ah_ids, self.knn_stats["antihub"] = build_knn(
                    data, 10, backend=p.knn_backend,
                    draws=fold_in(generator, 17, dev), with_stats=True)
            else:
                ah_ids = torch.as_tensor(antihub_knn_ids).to(dev)
            self.kept_idx = antihub_mod.antihub_keep_indices(
                data, p.antihub_keep, k=10, knn_ids=ah_ids)
            sub = data[self.kept_idx.long()]
        else:
            self.kept_idx = torch.arange(n, dtype=torch.int32, device=dev)
            sub = data
        synchronize(dev)
        stages["antihub"] = time.perf_counter() - t

        t = time.perf_counter()
        if p.pca_dim < d0:
            self.pca = fit_pca(sub, p.pca_dim)
            base = self.pca.transform(sub).contiguous()
        else:
            self.pca = None
            base = sub.contiguous()
        self.base = base
        synchronize(dev)
        stages["pca"] = time.perf_counter() - t

        t = time.perf_counter()
        knn_draws = fold_in(generator, 23, dev)
        if (resolve_backend(p.knn_backend, base.shape[0]) == "nndescent"
                and ah_ids is not None):
            # AntiHub reuse: filter the raw table to the kept subset, remap
            # its ids, and let a few NN-Descent patch rounds repair the
            # filtering and the projection instead of a from-scratch build
            kept = self.kept_idx.long()
            remap = torch.full((n,), -1, dtype=torch.int32, device=dev)
            remap[kept] = torch.arange(kept.shape[0], dtype=torch.int32,
                                       device=dev)
            kept_tab = ah_ids[kept]
            init = torch.where(kept_tab >= 0,
                               remap[kept_tab.clamp_min(0).long()], -1)
            knn_dists, self.knn_ids, stats = nn_descent(
                base, p.build_knn_k, draws=knn_draws, init_ids=init,
                init_passes=1, rounds=SUBSET_PATCH_ROUNDS, with_stats=True)
        else:
            knn_dists, self.knn_ids, stats = build_knn(
                base, p.build_knn_k, backend=p.knn_backend,
                draws=knn_draws, with_stats=True)
        self.knn_stats["knn"] = stats
        synchronize(dev)
        self.knn_seconds = stages["knn"] = time.perf_counter() - t

        pools = p.pools_backend
        if pools == "auto":
            # table-derived pools unless the kNN side is explicitly exact
            pools = "search" if p.knn_backend == "exact" else "nndescent"
        self.graph, self.build_stats = build_nsg(
            base, self.knn_ids, degree=p.graph_degree,
            n_candidates=p.build_candidates, alpha=p.alpha,
            pools_backend=pools, knn_dists=knn_dists,
            finish_backend=p.finish_backend, with_stats=True)
        stages["pools"] = self.build_stats.pools_seconds
        stages["prune"] = self.build_stats.prune_seconds
        stages["finish"] = (self.build_stats.interconnect_seconds
                            + self.build_stats.repair_seconds)

        t = time.perf_counter()
        self.eps = fit_entry_points(generator, base, p.ep_clusters)
        synchronize(dev)
        stages["entry_points"] = time.perf_counter() - t
        if p.dist_backend != "f32":
            t = time.perf_counter()
            self.quantize(generator=generator)
            stages["quantize"] = time.perf_counter() - t
        self.stage_seconds = stages
        self.build_seconds = time.perf_counter() - t0
        _N_STRUCTURAL_BUILDS += 1
        return self

    def quantize(self, dist_backend: Optional[str] = None,
                 pq_m: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None
                 ) -> "TunedGraphIndex":
        """Train a traversal codec on the projected base and encode it once.

        Called by ``fit`` when ``params.dist_backend != "f32"`` and by
        ``search`` when it is asked for another backend than the codec's;
        call it to quantize an f32-built index after the fact.
        ``generator`` draws the PQ k-means++ seeds (default: a CPU
        generator seeded with 0). The seconds of the codec fit and of the
        encode land in ``quantize_seconds``.
        """
        if self.base is None:
            raise RuntimeError("fit() first")
        p = self.params
        backend = dist_backend or (
            p.dist_backend if p.dist_backend != "f32" else "pq")
        m = pq_m if pq_m is not None else p.pq_m
        dev = self.device
        synchronize(dev)
        t = time.perf_counter()
        codec = make_codec(backend, self.base.shape[1], m)
        codec.fit(self.base, generator=generator)
        synchronize(dev)
        t_fit = time.perf_counter() - t
        t = time.perf_counter()
        self.codes = codec.encode(self.base).contiguous()
        synchronize(dev)
        self.quantize_seconds = {"fit": t_fit,
                                 "encode": time.perf_counter() - t}
        self.codec, self.codec_backend = codec, backend
        return self

    # -- rebuild-free derivation ("prune, don't rebuild") ------------------
    def with_graph(self, graph: NSGGraph) -> "TunedGraphIndex":
        """Shallow clone serving a different (derived) graph; it shares the
        base vectors, PCA, kept ids, entry points and codes with ``self``."""
        out = copy.copy(self)
        out.graph = graph
        return out

    def reprune(self, *, alpha: float = 1.0,
                degree: Optional[int] = None) -> "TunedGraphIndex":
        """Derive a lower-degree / larger-alpha index with no rebuild:
        O(N * R) gather-distances, one occlusion pass and the connectivity
        repair."""
        if self.graph is None:
            raise RuntimeError("fit() first")
        g = reprune_nsg(self.base, self.graph, alpha=alpha, degree=degree,
                        knn_ids=self.knn_ids,
                        finish_backend=self.params.finish_backend)
        out = self.with_graph(g)
        out.params = replace(self.params, alpha=alpha,
                             graph_degree=g.neighbors.shape[1])
        return out

    # -- search -----------------------------------------------------------
    def project(self, queries: torch.Tensor) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        return self.pca.transform(q) if self.pca is not None else q

    def search(self, queries, k: int, params=None, *,
               ef: Optional[int] = None,
               mode: Optional[str] = None, rerank: Optional[int] = None,
               dist_backend: Optional[str] = None,
               hop_backend: Optional[str] = None,
               patience: Optional[int] = None,
               eps: Optional[float] = None,
               compact_every: Optional[int] = None):
        """Returns (dists (Q, k) in projected space, original ids (Q, k)).

        ``params`` is a ``core.index_api.SearchParams``; explicit keywords
        win over it, both fall back to the fit-time params.

        Under ``dist_backend="pq"|"int8"`` the beam traverses the codec's
        uint8 codes (re-quantizing first if the index holds another codec)
        and its top ``rerank`` survivors are rescored exactly in f32: the
        returned distances are exact for reranked entries, LUT
        approximations when ``rerank=0``. ``patience``/``eps`` enable
        adaptive early termination (``patience=0``: off, the stock
        convergence rule bit for bit); both default to the fit-time params,
        as does ``compact_every``: > 0 serves through the compacted search
        (``core.beam_search.beam_search_compacted``, the fused hop loop in
        slices of that many hops, whatever ``hop_backend`` says), whose
        per-slice batch sizes land in ``last_compaction_shapes``.
        Per-hop work counters of the latest call are kept on the index —
        read them via ``search_stats()``.
        """
        if self.graph is None:
            raise RuntimeError("fit() first")
        if params is not None:
            ef = ef if ef is not None else params.ef_search
            mode = mode if mode is not None else params.mode
            rerank = rerank if rerank is not None else params.rerank
            dist_backend = dist_backend or params.dist_backend
            hop_backend = hop_backend or params.hop_backend
            patience = patience if patience is not None else params.patience
            eps = eps if eps is not None else params.eps
            compact_every = (compact_every if compact_every is not None
                             else params.compact_every)
        ef = ef or self.params.ef_search
        mode = mode or "while"
        dist_backend = check_dist_backend(
            dist_backend or self.params.dist_backend)
        rerank = rerank if rerank is not None else self.params.rerank
        hop_backend = hop_backend or self.params.hop_backend
        patience = patience if patience is not None else self.params.patience
        eps = eps if eps is not None else self.params.eps
        compact_every = (compact_every if compact_every is not None
                         else self.params.compact_every)
        q = self.project(queries).contiguous()
        entries = self.eps.select(q)
        bs_kw = dict(ef=max(ef, k), mode=mode, patience=patience or None,
                     eps=eps, with_stats=True)
        if dist_backend == "f32":
            kb = k
        else:
            if self.codec is None or self.codec_backend != dist_backend:
                self.quantize(dist_backend)
            # keep enough LUT-ranked survivors for the exact tail to pick
            # a true top-k from
            kb = min(max(rerank, k), max(ef, k))
            bs_kw.update(dist_backend=dist_backend, codes=self.codes,
                         lut=self.codec.lut(q))
        self.last_compaction_shapes = None
        if compact_every:
            shape_log: list = []
            d, i, stats = beam_search_compacted(
                q, self.base, self.graph.neighbors, entries, k=kb,
                compact_every=compact_every, shape_log=shape_log, **bs_kw)
            self.last_compaction_shapes = shape_log
        else:
            d, i, stats = beam_search(q, self.base, self.graph.neighbors,
                                      entries, k=kb, hop_backend=hop_backend,
                                      **bs_kw)
        if dist_backend != "f32":
            if rerank > 0:
                d, i = _exact_rerank(q, self.base, i, k)
            else:
                d, i = d[:, :k], i[:, :k]
        self.last_search_stats = stats
        orig = torch.where(i >= 0, self.kept_idx[i.clamp_min(0).long()], -1)
        return d, orig

    def search_stats(self) -> Optional[dict]:
        """Per-hop work counters of the latest ``search`` call (totals over
        queries, plus the per-query hop distribution)."""
        s = self.last_search_stats
        if s is None:
            return None
        hops = s.hops.cpu().numpy()
        total = int(hops.sum())
        wasted = int(s.wasted_hops.sum())
        return {"hops": total,
                "gathered": int(s.gathered.sum()),
                "dup_gathered": int(s.dup_gathered.sum()),
                "wasted_hops": wasted,
                "active_fraction": float(total / max(total + wasted, 1)),
                "mean_hops": float(hops.mean()) if hops.size else 0.0,
                "p99_hops": float(np.percentile(hops, 99))
                if hops.size else 0.0}

    @property
    def ntotal(self) -> int:
        return 0 if self.base is None else self.base.shape[0]

    @property
    def dim(self) -> int:
        """Query-time input dimensionality (pre-PCA original space)."""
        return self.input_dim

    def search_params_space(self):
        from repro_torch.core.index_api import (
            ef_search_space, patience_space, rerank_space,
        )
        space = ef_search_space()
        if self.params.dist_backend != "f32" or self.codec is not None:
            space = rerank_space(space)
        return patience_space(space)

    def memory_bytes(self) -> int:
        """Index footprint: vectors + graph + entry-point structures +
        quantized codes and codebooks (when a codec is attached)."""
        total = self.base.numel() * self.base.element_size()
        total += self.graph.neighbors.numel() * 4
        total += self.kept_idx.numel() * 4
        if self.pca is not None:
            total += (self.pca.components.numel() + self.pca.mean.numel()) * 4
        total += (self.eps.centroids.numel() * 4
                  + self.eps.member_ids.numel() * 4)
        if self.codes is not None:
            total += self.codes.numel() * self.codes.element_size()
        if self.codec is not None:
            total += self.codec.memory_bytes()
        return int(total)

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        """Complete serving state as numpy arrays, in the reference's
        ``{"meta", "arrays"}`` layout (so either package can load it)."""
        if self.graph is None:
            raise RuntimeError("fit() first")
        arrays = {"kept_idx": self.kept_idx, "base": self.base,
                  "neighbors": self.graph.neighbors,
                  "medoid": self.graph.medoid,
                  "eps_centroids": self.eps.centroids,
                  "eps_member_ids": self.eps.member_ids}
        if self.knn_ids is not None:
            arrays["knn_ids"] = self.knn_ids
        if self.pca is not None:
            arrays["pca_mean"] = self.pca.mean
            arrays["pca_components"] = self.pca.components
            arrays["pca_explained"] = self.pca.explained
        if self.codec is not None:
            arrays["codes"] = self.codes
            if isinstance(self.codec, PQCodec):
                arrays["codec_codebooks"] = self.codec.codebooks
            else:                                     # int8 scalar codec
                arrays["codec_scale"] = self.codec.scale
                arrays["codec_zero"] = self.codec.zero
        return {"meta": {"params": asdict(self.params),
                         "input_dim": self.input_dim,
                         "codec_backend": self.codec_backend,
                         "build_seconds": self.build_seconds},
                "arrays": {k: v.cpu().numpy() for k, v in arrays.items()}}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "TunedGraphIndex":
        meta, a = state["meta"], state["arrays"]
        idx = cls(IndexParams(**meta["params"]), device=device)
        dev = idx.device
        t = lambda name: torch.from_numpy(np.array(a[name])).to(dev)
        idx.input_dim = int(meta["input_dim"])
        idx.build_seconds = float(meta.get("build_seconds", 0.0))
        idx.kept_idx = t("kept_idx").to(torch.int32)
        idx.base = t("base").float().contiguous()
        idx.graph = NSGGraph(neighbors=t("neighbors").to(torch.int32)
                             .contiguous(),
                             medoid=t("medoid").to(torch.int32))
        idx.eps = EntryPointSelector(
            centroids=t("eps_centroids").float(),
            member_ids=t("eps_member_ids").to(torch.int32))
        if "knn_ids" in a:
            idx.knn_ids = t("knn_ids").to(torch.int32)
        if "pca_mean" in a:
            idx.pca = PCA(mean=t("pca_mean").float(),
                          components=t("pca_components").float(),
                          explained=t("pca_explained").float())
        backend = meta.get("codec_backend")
        if backend is not None:
            if "codec_codebooks" in a:                # PQ
                books = t("codec_codebooks").float()
                codec = PQCodec(books.shape[0], books.shape[1])
                codec.codebooks = books
            else:                                     # int8
                codec = Int8Codec()
                codec.scale = t("codec_scale").float()
                codec.zero = t("codec_zero").float()
            idx.codec, idx.codec_backend = codec, backend
            idx.codes = t("codes").to(torch.uint8).contiguous()
        return idx


def _exact_rerank(queries: torch.Tensor, base: torch.Tensor,
                  ids: torch.Tensor, k: int):
    """Exact f32 squared-L2 rescoring of the (Q, R') beam survivors -> top-k.

    One gather_dist block over the survivor ids (the kernel on CUDA, its
    plain diff-square version on the CPU), then ``smallest_k``: among equal
    distances the lower survivor position comes first, the tie rule of the
    reference's ``lax.top_k(-d, k)``. Padded ids (-1) carry +inf and sort
    last.
    """
    d, pos = smallest_k(gather_dist(queries, base, ids), k)
    return d, ids.gather(1, pos.long())


def build_vanilla_nsg(data, *, degree: int = 32, ef_search: int = 64,
                      device=None, **kw) -> TunedGraphIndex:
    """Paper's baseline: no PCA, no subsampling, medoid entry point."""
    p = IndexParams(pca_dim=data.shape[1], antihub_keep=1.0, ep_clusters=1,
                    ef_search=ef_search, graph_degree=degree, **kw)
    return TunedGraphIndex(p, device=device).fit(data)
