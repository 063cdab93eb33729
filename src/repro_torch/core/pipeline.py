"""The paper's end-to-end pipeline (Fig. 2): AntiHub subsample -> PCA ->
NSG build -> k-means entry points; search = project -> select EP -> beam.

``IndexParams`` carries every knob of the reference's, so a reference
state's ``meta["params"]`` loads as is. The port runs the configuration
of this slice: f32 serving, the exact kNN table, search pools and the host
finishing pass. Every other option raises ``NotImplementedError`` naming
the ROADMAP item that brings it.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ANNConfig
from repro_torch.core import antihub as antihub_mod
from repro_torch.core.beam_search import BeamStats, beam_search
from repro_torch.core.build import build_knn
from repro_torch.core.build.finish import require_host
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.entry_points import EntryPointSelector, fit_entry_points
from repro_torch.core.nsg import NSGGraph, build_nsg
from repro_torch.core.pca import PCA, fit_pca


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


def _check_serving(dist_backend: str, patience: int, compact_every: int):
    if dist_backend != "f32":
        raise NotImplementedError(
            f"dist_backend={dist_backend!r}: quantized traversal is not "
            f"ported yet (ROADMAP Queue 1 item 3)")
    if patience or compact_every:
        raise NotImplementedError(
            "patience / compact_every: straggler control is not ported yet "
            "(ROADMAP Queue 1 item 4)")


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
        self.stage_seconds: dict = {}                 # per build stage
        self.build_stats = None                       # NSGBuildStats of fit
        self.input_dim: int = 0
        self.knn_ids: Optional[torch.Tensor] = None   # build-time kNN table
        self.last_search_stats: Optional[BeamStats] = None

    # -- build ------------------------------------------------------------
    def fit(self, data, generator: Optional[torch.Generator] = None):
        """Build the full pipeline; ``generator`` draws the k-means++ init
        (default: a CPU generator seeded with 0)."""
        p = self.params
        _check_serving(p.dist_backend, p.patience, p.compact_every)
        pools = p.pools_backend
        if pools == "auto":
            pools = "search" if p.knn_backend == "exact" else "nndescent"
        if pools != "search":
            raise NotImplementedError(
                f"pools_backend={p.pools_backend!r} resolves to table-derived "
                f"pools, not ported yet (ROADMAP Queue 1 item 5, the "
                f"NN-Descent slice); pass knn_backend='exact'")
        require_host(p.finish_backend)
        dev = self.device
        generator = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        t0 = time.perf_counter()
        stages = {}
        data = torch.as_tensor(data, dtype=torch.float32).to(dev)
        n, d0 = data.shape
        self.input_dim = d0

        t = time.perf_counter()
        if p.antihub_keep < 1.0:
            _, ah_ids = build_knn(data, 10, backend=p.knn_backend)
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
        _, self.knn_ids = build_knn(base, p.build_knn_k,
                                    backend=p.knn_backend)
        synchronize(dev)
        stages["knn"] = time.perf_counter() - t

        self.graph, self.build_stats = build_nsg(
            base, self.knn_ids, degree=p.graph_degree,
            n_candidates=p.build_candidates, alpha=p.alpha,
            pools_backend="search", finish_backend=p.finish_backend,
            with_stats=True)
        stages["pools"] = self.build_stats.pools_seconds
        stages["prune"] = self.build_stats.prune_seconds
        stages["finish"] = (self.build_stats.interconnect_seconds
                            + self.build_stats.repair_seconds)

        t = time.perf_counter()
        self.eps = fit_entry_points(generator, base, p.ep_clusters)
        synchronize(dev)
        stages["entry_points"] = time.perf_counter() - t
        self.stage_seconds = stages
        self.build_seconds = time.perf_counter() - t0
        return self

    # -- search -----------------------------------------------------------
    def project(self, queries: torch.Tensor) -> torch.Tensor:
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        return self.pca.transform(q) if self.pca is not None else q

    def search(self, queries, k: int, *, ef: Optional[int] = None,
               mode: Optional[str] = None,
               hop_backend: Optional[str] = None):
        """Returns (dists (Q, k) in projected space, original ids (Q, k)).

        Per-hop work counters of the latest call are kept on the index —
        read them via ``search_stats()``.
        """
        if self.graph is None:
            raise RuntimeError("fit() first")
        _check_serving(self.params.dist_backend, self.params.patience,
                       self.params.compact_every)
        ef = ef or self.params.ef_search
        mode = mode or "while"
        hop_backend = hop_backend or self.params.hop_backend
        q = self.project(queries).contiguous()
        entries = self.eps.select(q)
        d, i, stats = beam_search(q, self.base, self.graph.neighbors,
                                  entries, ef=max(ef, k), k=k, mode=mode,
                                  hop_backend=hop_backend, with_stats=True)
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

    def memory_bytes(self) -> int:
        """Index footprint: vectors + graph + entry-point structures."""
        total = self.base.numel() * self.base.element_size()
        total += self.graph.neighbors.numel() * 4
        total += self.kept_idx.numel() * 4
        if self.pca is not None:
            total += (self.pca.components.numel() + self.pca.mean.numel()) * 4
        total += (self.eps.centroids.numel() * 4
                  + self.eps.member_ids.numel() * 4)
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
        return {"meta": {"params": asdict(self.params),
                         "input_dim": self.input_dim,
                         "codec_backend": None,
                         "build_seconds": self.build_seconds},
                "arrays": {k: v.cpu().numpy() for k, v in arrays.items()}}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "TunedGraphIndex":
        meta, a = state["meta"], state["arrays"]
        if meta.get("codec_backend") is not None or "codes" in a:
            raise NotImplementedError(
                "codec state (quantized traversal) is not ported yet "
                "(ROADMAP Queue 1 item 3)")
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
        return idx


def build_vanilla_nsg(data, *, degree: int = 32, ef_search: int = 64,
                      device=None, **kw) -> TunedGraphIndex:
    """Paper's baseline: no PCA, no subsampling, medoid entry point."""
    p = IndexParams(pca_dim=data.shape[1], antihub_keep=1.0, ep_clusters=1,
                    ef_search=ef_search, graph_degree=degree, **kw)
    return TunedGraphIndex(p, device=device).fit(data)
