"""Index integrity validation — the trust boundary of snapshot restore (the
reference's ``core/validate.py``).

``validate_index`` checks the structural invariants every serving path
assumes but none re-checks per query: neighbor ids in range (or -1 pad),
meta/array degree agreement, entry points that exist, finite vectors and
LUT tables, PQ geometry (``m | dim``, codes < n_centroids), and a seeded
reachability spot-check on graph indexes. A violation raises
``IndexIntegrityError`` naming the invariant; ``core.persist.load_index``
runs it after checksum verification. The checks run where the arrays live
(on the card for a card-resident index), and the reachability check's
frontier propagation costs O(rounds * N * R) on the device. A sharded
index is checked shard by shard, plus its hoisted PCA.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


class IndexIntegrityError(ValueError):
    """A structural invariant does not hold; ``invariant`` names which."""

    def __init__(self, invariant: str, message: str):
        super().__init__(f"[{invariant}] {message}")
        self.invariant = invariant


def _fail(invariant: str, message: str):
    raise IndexIntegrityError(invariant, message)


def _t(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr))


def _check_finite(name: str, arr) -> None:
    a = _t(arr)
    if a.is_floating_point() and not bool(torch.isfinite(a).all()):
        _fail("finite", f"{name} contains non-finite values")


def _check_neighbors(nbrs, n: int, what: str = "neighbors") -> None:
    a = _t(nbrs)
    if a.numel():
        lo, hi = int(a.min()), int(a.max())
        if lo < -1 or hi >= n:
            _fail("neighbor_range",
                  f"{what} ids must be in [-1, {n}), got [{lo}, {hi}]")


def _check_entry_points(eps, n: int) -> None:
    if eps is None:
        _fail("entry_points", "index has no entry-point selector")
    members = _t(eps.member_ids)
    if members.numel() == 0:
        _fail("entry_points", "entry-point member list is empty")
    lo, hi = int(members.min()), int(members.max())
    if lo < 0 or hi >= n:
        _fail("entry_points",
              f"entry-point ids must be in [0, {n}), got [{lo}, {hi}]")
    _check_finite("entry-point centroids", eps.centroids)


def _check_codec(codec, codes, dim: int) -> None:
    """PQ/int8 codec geometry: ``m | dim``, codes below the codebook size,
    finite codebooks / strictly positive scales (the LUT inputs)."""
    books = getattr(codec, "codebooks", None)
    if books is not None:                        # PQ
        m, c, dsub = books.shape
        if m * dsub != dim:
            _fail("pq_geometry",
                  f"PQ codebooks ({m} x {dsub}-dim subspaces) do not tile "
                  f"the indexed dim {dim}")
        _check_finite("PQ codebooks", books)
        if codes is not None:
            cod = _t(codes)
            if cod.shape[1] != m:
                _fail("pq_geometry",
                      f"codes have {cod.shape[1]} subspaces, codebooks {m}")
            if cod.numel() and int(cod.max()) >= c:
                _fail("pq_codes",
                      f"code values must be < n_centroids={c}, got "
                      f"{int(cod.max())}")
    scale = getattr(codec, "scale", None)
    if scale is not None:                        # int8
        s = _t(scale)
        if s.shape[0] != dim:
            _fail("sq8_geometry",
                  f"int8 scale has {s.shape[0]} dims, index has {dim}")
        if not bool(torch.isfinite(s).all()) or bool((s <= 0).any()):
            _fail("sq8_scale", "int8 scales must be finite and > 0")
        _check_finite("int8 zero-points", codec.zero)


def _spot_check_reachability(neighbors, entries, *, sample: int = 64,
                             seed: int = 0) -> None:
    """A seeded sample of nodes must be reachable from the entry points.

    Frontier propagation over the neighbor table, on the table's device:
    exactly the property the NSG connectivity repair guarantees; a
    truncated or byte-shifted neighbors array that still passes the range
    check fails here. The sample is the reference's (same seed, same
    numpy draw).
    """
    nbrs = _t(neighbors).long()
    n = nbrs.shape[0]
    if n == 0:
        return
    dev = nbrs.device
    reached = torch.zeros(n, dtype=torch.bool, device=dev)
    entry = _t(entries).to(dev).long().reshape(-1)
    reached[entry[(entry >= 0) & (entry < n)]] = True
    frontier = reached.clone()
    while bool(frontier.any()):
        nxt = nbrs[frontier].reshape(-1)
        nxt = nxt[nxt >= 0]
        new = torch.zeros(n, dtype=torch.bool, device=dev)
        new[nxt] = True
        frontier = new & ~reached
        reached |= frontier
    rng = np.random.default_rng(seed)
    picks = rng.choice(n, size=min(sample, n), replace=False)
    hit = reached[torch.as_tensor(picks, device=dev)].cpu().numpy()
    missing = picks[~hit]
    if missing.size:
        _fail("reachability",
              f"{missing.size}/{picks.size} sampled nodes unreachable from "
              f"the entry points (e.g. node {int(missing[0])})")


# -- per-family validators ---------------------------------------------------


def _validate_flat(idx) -> None:
    if idx.data is None:
        _fail("fitted", "FlatIndex has no data (not fitted)")
    _check_finite("data", idx.data)


def _validate_ivf(idx) -> None:
    if idx.data is None or idx.lists is None:
        _fail("fitted", "IVFIndex missing data/lists (not fitted)")
    _check_finite("data", idx.data)
    _check_finite("centroids", idx.centroids)
    _check_neighbors(idx.lists, idx.ntotal, "posting-list")
    if idx.centroids.shape[0] != idx.n_lists:
        _fail("ivf_lists", f"{idx.centroids.shape[0]} centroids "
                           f"for n_lists={idx.n_lists}")


def _validate_ivfpq(idx) -> None:
    if idx.lists is None or idx.pq is None:
        _fail("fitted", "IVFPQIndex missing lists/pq (not fitted)")
    _check_finite("centroids", idx.centroids)
    _check_neighbors(idx.lists, idx.ntotal, "posting-list")
    books = idx.pq.codebooks
    m, c, dsub = books.shape
    if m * dsub != idx.dim:
        _fail("pq_geometry",
              f"PQ codebooks ({m} x {dsub}) do not tile dim {idx.dim}")
    _check_finite("PQ codebooks", books)
    codes = _t(idx.list_codes)
    if codes.numel() and int(codes.max()) >= c:
        _fail("pq_codes", f"list codes must be < {c}, got {int(codes.max())}")


def _validate_pq(idx) -> None:
    if idx.codes is None:
        _fail("fitted", "PQIndex has no codes (not fitted)")
    _check_codec(idx.codec, idx.codes, idx.dim)


def _validate_hnsw(idx) -> None:
    if idx.data is None or not idx.layers:
        _fail("fitted", "HNSWIndex missing data/layers (not fitted)")
    n = idx.ntotal
    _check_finite("data", idx.data)
    for li, layer in enumerate(idx.layers):
        _check_neighbors(layer, n, f"layer-{li}")
        if layer.shape[1] > (idx.m0 if li == 0 else idx.m):
            _fail("degree", f"layer {li} degree {layer.shape[1]} exceeds "
                            f"m={idx.m0 if li == 0 else idx.m}")
    if not 0 <= idx.entry < n:
        _fail("entry_points", f"entry node {idx.entry} out of [0, {n})")
    if idx.eps is not None:
        _check_entry_points(idx.eps, n)


def _validate_tuned_graph(idx, *, sample: int = 64, seed: int = 0) -> None:
    if idx.graph is None:
        _fail("fitted", "TunedGraphIndex has no graph (not fitted)")
    n = idx.base.shape[0]
    _check_finite("base vectors", idx.base)
    _check_neighbors(idx.graph.neighbors, n)
    r = idx.graph.neighbors.shape[1]
    if r != idx.params.graph_degree:
        _fail("degree",
              f"neighbors table width {r} != params.graph_degree "
              f"{idx.params.graph_degree} (meta/array desync)")
    medoid = int(idx.graph.medoid)
    if not 0 <= medoid < n:
        _fail("entry_points", f"medoid {medoid} out of [0, {n})")
    _check_entry_points(idx.eps, n)
    kept = _t(idx.kept_idx)
    if kept.shape[0] != n or (kept.numel() and int(kept.min()) < 0):
        _fail("kept_idx", "kept_idx must map every base row to an original "
                          "database id >= 0")
    if idx.codec is not None:
        _check_codec(idx.codec, idx.codes, idx.base.shape[1])
    members = _t(idx.eps.member_ids).reshape(-1)
    _spot_check_reachability(
        idx.graph.neighbors,
        torch.cat([members.long(),
                   torch.tensor([medoid], device=members.device)]),
        sample=sample, seed=seed)


def _validate_preprocessed(idx, **kw) -> None:
    if idx.pca is None:
        _fail("fitted", "PreprocessedIndex has no PCA (not fitted)")
    _check_finite("PCA mean", idx.pca.mean)
    _check_finite("PCA components", idx.pca.components)
    validate_index(idx.inner, **kw)


def _validate_sharded_factory(idx, **kw) -> None:
    if not idx.subs:
        _fail("fitted", "ShardedFactoryIndex has no shards (not fitted)")
    if idx.pca is not None:
        _check_finite("PCA components", idx.pca.components)
    for s in idx.subs:
        validate_index(s, **kw)


_VALIDATORS: Dict[str, Callable] = {
    "FlatIndex": _validate_flat,
    "IVFIndex": _validate_ivf,
    "IVFPQIndex": _validate_ivfpq,
    "PQIndex": _validate_pq,
    "HNSWIndex": _validate_hnsw,
    "TunedGraphIndex": _validate_tuned_graph,
    "PreprocessedIndex": _validate_preprocessed,
    "ShardedFactoryIndex": _validate_sharded_factory,
}


def validate_index(index, *, sample: int = 64, seed: int = 0) -> None:
    """Check every applicable invariant; raise ``IndexIntegrityError`` on
    the first violation, return ``None`` when the index is sound.

    ``sample``/``seed`` size the reachability spot-check on graph indexes
    (the only probabilistic part — seeded, so a given index always passes
    or always fails).
    """
    fam = type(index).__name__
    fn = _VALIDATORS.get(fam)
    if fn is None:
        _fail("family", f"no validator for index family {fam!r}")
    if fam in ("TunedGraphIndex", "PreprocessedIndex",
               "ShardedFactoryIndex"):
        fn(index, sample=sample, seed=seed)
    else:
        fn(index)
