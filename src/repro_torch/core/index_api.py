"""Unified ``Index`` protocol + faiss-style factory registry (the
reference's ``core/index_api.py``).

  * ``Index`` — the structural protocol every index family implements:
    ``fit(data, generator=None)``, ``search(queries, k, params)``,
    ``ntotal``, ``dim``, ``search_params_space()`` and ``state_dict()``.
  * ``SearchParams`` — one frozen dataclass holding every *runtime* search
    knob (``ef_search``, ``nprobe``, ...). ``None`` falls back to the
    index's own default, so a ``SearchParams`` re-tunes an index without a
    refit.
  * ``build_index(spec, data)`` — the factory: ``spec`` is a comma-separated
    string mirroring faiss, an optional ``PCA<d>`` prefix composed with any
    registered component, e.g. ``"Flat"``, ``"PCA16,IVF64"``,
    ``"IVF64,PQ8"``, ``"IVFPQ64x8"``, ``"HNSW32,Flat"``,
    ``"NSG32,AH0.9,EP16"``. New families plug in through
    ``register_index``.

The index runs on ``device`` (the card unless the caller says otherwise):
``build_index`` moves the data there, and a built-in factory that takes a
``device`` argument is handed it. Random draws (k-means++ seeds, the entry
points) come from ``generator`` where the reference takes ``key``.
"""
from __future__ import annotations

import inspect
import re
from dataclasses import dataclass, replace
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, Optional, Protocol, Tuple,
    runtime_checkable,
)

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.pca import PCA, fit_pca

if TYPE_CHECKING:   # annotation-only: a runtime import would cycle through
    from repro_torch.core.tuning.space import SearchSpace  # tuning/__init__


# ---------------------------------------------------------------------------
# SearchParams
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SearchParams:
    """Runtime search knobs, uniform across index families.

    ``None`` means "use the index's configured default". Frozen, hence
    hashable.

    Which index reads what:
      * ``ef_search``    — beam width: HNSW, NSG/TunedGraph
      * ``nprobe``       — probed inverted lists: IVF, IVF-PQ
      * ``mode``         — graph traversal loop form ("while" | "fori")
      * ``chunk``        — brute-force streaming block: Flat
      * ``rerank``       — exact-rescore depth of the quantized beam tail
      * ``dist_backend`` — traversal precision ("f32" | "pq" | "int8")
      * ``hop_backend``  — beam-hop fusion ("staged" | "fused" | "auto")
      * ``patience`` / ``eps`` — adaptive early termination (0 = off)
      * ``compact_every`` — active-query compaction slice length (0 = off)
    """
    ef_search: Optional[int] = None
    nprobe: Optional[int] = None
    mode: Optional[str] = None
    chunk: Optional[int] = None
    rerank: Optional[int] = None
    dist_backend: Optional[str] = None
    hop_backend: Optional[str] = None
    patience: Optional[int] = None
    eps: Optional[float] = None
    compact_every: Optional[int] = None

    def resolve(self, name: str, default):
        v = getattr(self, name)
        return default if v is None else v


def param_or(params: Optional[SearchParams], name: str, default):
    """``params.name`` if set, else ``default`` — tolerant of ``params=None``."""
    if params is None:
        return default
    return params.resolve(name, default)


# Shared space fragments (lazy tuning.space import: it sits above this
# module). Index families delegate here so knob ranges stay in one place.


def ef_search_space(low: int = 16, high: int = 256) -> "SearchSpace":
    """Beam-width fragment shared by the graph indexes (HNSW, NSG)."""
    from repro_torch.core.tuning.space import Int, SearchSpace
    return SearchSpace().add("ef_search", Int(low, high, log=True))


def rerank_space(space: Optional["SearchSpace"] = None, low: int = 8,
                 high: int = 128) -> "SearchSpace":
    """Exact-rerank-depth fragment for quantized-traversal indexes; pass an
    existing fragment to extend it."""
    from repro_torch.core.tuning.space import Int, SearchSpace
    space = space if space is not None else SearchSpace()
    return space.add("rerank", Int(low, high, log=True))


def patience_space(space: Optional["SearchSpace"] = None,
                   high: int = 16) -> "SearchSpace":
    """Adaptive-termination fragment (``patience=0`` disables the rule)."""
    from repro_torch.core.tuning.space import Int, SearchSpace
    space = space if space is not None else SearchSpace()
    return space.add("patience", Int(0, high))


def nprobe_space(n_lists: int) -> "SearchSpace":
    """Probed-lists fragment shared by the IVF family."""
    from repro_torch.core.tuning.space import Int, SearchSpace
    return SearchSpace().add("nprobe", Int(1, n_lists, log=True))


def empty_space() -> "SearchSpace":
    """For families with no runtime knob (PQ)."""
    from repro_torch.core.tuning.space import SearchSpace
    return SearchSpace()


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class Index(Protocol):
    """Structural interface every index family conforms to."""

    def fit(self, data: torch.Tensor,
            generator: Optional[torch.Generator] = None):
        """Build from (N, D) vectors; returns self."""
        ...

    def search(self, queries: torch.Tensor, k: int,
               params: Optional[SearchParams] = None):
        """(Q, D) queries -> ((Q, k) dists, (Q, k) database ids)."""
        ...

    @property
    def ntotal(self) -> int:
        ...

    @property
    def dim(self) -> int:
        """Dimensionality of the vectors the index accepts at query time."""
        ...

    def search_params_space(self) -> "SearchSpace":
        """This index's tunable SearchParams fields as a space fragment."""
        ...

    def state_dict(self) -> dict:
        """Complete serving state as ``{"meta": <JSON-safe>, "arrays":
        <flat name -> numpy array>}``, each array in the reference's dtype
        (``core.persist``); ``from_state`` inverts it with bit-identical
        search results."""
        ...


# ---------------------------------------------------------------------------
# Factory registry
# ---------------------------------------------------------------------------

# build(match, rest_tokens, dim[, device]) -> (unfitted index, n_extra_tokens)
FactoryFn = Callable[..., Tuple[Any, int]]


@dataclass(frozen=True)
class IndexFactory:
    name: str
    pattern: "re.Pattern[str]"
    build: FactoryFn
    grammar: str
    examples: Tuple[str, ...] = ()
    takes_device: bool = False


_REGISTRY: Dict[str, IndexFactory] = {}
_PCA_TOKEN = re.compile(r"^PCA(\d+)$")


def register_index(name: str, pattern: str, grammar: str = "",
                   examples: Tuple[str, ...] = ()):
    """Decorator: register a factory for spec tokens matching ``pattern``.

    The decorated fn receives (regex match for the head token, the remaining
    tokens, the post-preprocessing dimensionality) — plus ``device=`` when
    its signature names it — and returns the unfitted index and how many
    extra tokens it consumed. ``examples`` are small representative specs
    of this family (``available_factories``).
    """
    def deco(fn: FactoryFn) -> FactoryFn:
        takes = "device" in inspect.signature(fn).parameters
        _REGISTRY[name] = IndexFactory(name, re.compile(pattern), fn,
                                       grammar or pattern, tuple(examples),
                                       takes)
        return fn
    return deco


def list_index_specs() -> Dict[str, str]:
    """Registered component name -> grammar (for error messages / docs)."""
    _ensure_builtins()
    return {f.name: f.grammar for f in _REGISTRY.values()}


def available_factories() -> Dict[str, Tuple[str, ...]]:
    """Component name -> its registered example specs."""
    _ensure_builtins()
    return {f.name: f.examples for f in _REGISTRY.values() if f.examples}


def split_pca_prefix(spec: str) -> Tuple[Optional[int], str]:
    """Split a factory string -> (pca_dim or None, inner spec string)."""
    tokens = [t.strip() for t in spec.split(",") if t.strip()]
    if not tokens:
        raise ValueError(f"empty index spec {spec!r}")
    m = _PCA_TOKEN.match(tokens[0])
    if m:
        if len(tokens) == 1:
            raise ValueError(f"spec {spec!r} has a PCA prefix but no index")
        return int(m.group(1)), ",".join(tokens[1:])
    return None, ",".join(tokens)


def parse_spec(spec: str, dim: int, *, device=None
               ) -> Tuple[Optional[int], Any]:
    """Parse a factory string -> (pca_dim or None, unfitted index on
    ``device``, default the card)."""
    _ensure_builtins()
    pca_dim, inner = split_pca_prefix(spec)
    tokens = inner.split(",")
    inner_dim = pca_dim if pca_dim is not None else dim
    head, rest = tokens[0], tuple(tokens[1:])
    for fac in _REGISTRY.values():
        m = fac.pattern.match(head)
        if m:
            kw = {"device": device} if fac.takes_device else {}
            index, used = fac.build(m, rest, inner_dim, **kw)
            leftover = rest[used:]
            if leftover:
                raise ValueError(
                    f"unrecognized trailing tokens {list(leftover)} in "
                    f"spec {spec!r}")
            return pca_dim, index
    raise ValueError(
        f"no registered index matches {head!r}; known components: "
        f"{list_index_specs()}")


def build_index(spec: str, data, *,
                generator: Optional[torch.Generator] = None,
                device=None,
                knn_backend: Optional[str] = None,
                finish_backend: Optional[str] = None,
                dist_backend: Optional[str] = None,
                rerank: Optional[int] = None,
                hop_backend: Optional[str] = None,
                patience: Optional[int] = None,
                eps: Optional[float] = None,
                compact_every: Optional[int] = None) -> Index:
    """Build + fit an index from a factory string (the one-call entry point).

    The data moves to ``device`` (default: the card) and the index is fit
    there; ``generator`` draws its random seeds. ``knn_backend``,
    ``finish_backend``, ``dist_backend``, ``rerank``, ``hop_backend``,
    ``patience``, ``eps`` and ``compact_every`` override the fields of the
    same names in a family's ``params`` (NSG), as the reference's do.

    >>> idx = build_index("PCA16,IVF64", data, device="cpu")
    >>> dists, ids = idx.search(queries, 10, SearchParams(nprobe=4))
    """
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.float32).to(dev)
    pca_dim, index = parse_spec(spec, data.shape[1], device=dev)
    overrides = {k: v for k, v in (("knn_backend", knn_backend),
                                   ("finish_backend", finish_backend),
                                   ("dist_backend", dist_backend),
                                   ("rerank", rerank),
                                   ("hop_backend", hop_backend),
                                   ("patience", patience),
                                   ("eps", eps),
                                   ("compact_every", compact_every))
                 if v is not None}
    if overrides:
        params = getattr(index, "params", None)
        if params is not None:
            overrides = {k: v for k, v in overrides.items()
                         if hasattr(params, k)}
            if overrides:
                index.params = replace(params, **overrides)
    if pca_dim is not None:
        index = PreprocessedIndex(pca_dim, index)
    index = index.fit(data, generator=generator)
    index.spec = spec
    return index


# ---------------------------------------------------------------------------
# Preprocessing composition (the paper's d' knob, for arbitrary inner indexes)
# ---------------------------------------------------------------------------


class PreprocessedIndex:
    """PCA transform composed with any inner index (spec prefix ``PCA<d>``).

    Fits the projection on the database, fits the inner index in the reduced
    space, and projects queries on the way in — ids and distances come back
    from the inner index (distances are in the projected space).
    """

    def __init__(self, pca_dim: int, inner):
        self.pca_dim = pca_dim
        self.inner = inner
        self.pca: Optional[PCA] = None
        self.input_dim: Optional[int] = None

    def fit(self, data, generator: Optional[torch.Generator] = None):
        data = torch.as_tensor(data, dtype=torch.float32)
        self.input_dim = data.shape[1]
        self.pca = fit_pca(data, self.pca_dim)
        self.inner.fit(self.pca.transform(data), generator=generator)
        return self

    def search(self, queries, k: int, params: Optional[SearchParams] = None):
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            self.pca.mean.device)
        return self.inner.search(self.pca.transform(q), k, params)

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def ntotal(self) -> int:
        return self.inner.ntotal

    @property
    def dim(self) -> int:
        return self.input_dim if self.input_dim is not None else self.pca_dim

    def search_params_space(self) -> "SearchSpace":
        return self.inner.search_params_space()

    def memory_bytes(self) -> int:
        total = (self.pca.components.numel() + self.pca.mean.numel()) * 4 \
            if self.pca is not None else 0
        inner_mem = getattr(self.inner, "memory_bytes", None)
        return int(total + (inner_mem() if inner_mem else 0))

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        from repro_torch.core.persist import index_state
        sub = index_state(self.inner)
        arrays = {"pca_mean": self.pca.mean.cpu().numpy(),
                  "pca_components": self.pca.components.cpu().numpy(),
                  "pca_explained": self.pca.explained.cpu().numpy()}
        arrays.update({f"inner/{k}": v for k, v in sub["arrays"].items()})
        return {"meta": {"pca_dim": self.pca_dim,
                         "input_dim": self.input_dim,
                         "inner": {"family": sub["family"],
                                   "meta": sub["meta"]}},
                "arrays": arrays}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "PreprocessedIndex":
        from repro_torch.core.persist import index_from_state
        meta, a = state["meta"], state["arrays"]
        inner = index_from_state({
            "family": meta["inner"]["family"],
            "meta": meta["inner"]["meta"],
            "arrays": {k[len("inner/"):]: v for k, v in a.items()
                       if k.startswith("inner/")}}, device=device)
        idx = cls(meta["pca_dim"], inner)
        idx.input_dim = meta["input_dim"]
        dev = inner.device
        t = lambda name: torch.as_tensor(a[name], dtype=torch.float32).to(
            dev)
        idx.pca = PCA(mean=t("pca_mean"), components=t("pca_components"),
                      explained=t("pca_explained"))
        return idx


# ---------------------------------------------------------------------------
# Built-in component factories
# ---------------------------------------------------------------------------
# Registration is lazy (first parse triggers it) so the index modules can
# import index_api helpers (param_or, SearchParams) without an import cycle.


_builtins_registered = False


def _check_pq_m(pq_m: int, dim: int, tok: str) -> None:
    # a PQ subquantizer count that does not divide the indexed dim would
    # ragged-split the vector: refuse it at parse time. dim <= 1 is a
    # placeholder parse (the real dim is not known yet).
    if dim > 1 and dim % pq_m != 0:
        raise ValueError(
            f"PQ m={pq_m} must divide the indexed dimensionality {dim} "
            f"(token {tok!r}): each subquantizer codes dim/m contiguous "
            f"components. Pick m from the divisors of {dim}.")


def _ensure_builtins():
    global _builtins_registered
    if _builtins_registered:
        return
    from repro_torch.core.flat import FlatIndex
    from repro_torch.core.hnsw import HNSWIndex
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.ivfpq import IVFPQIndex
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    from repro_torch.core.pq import PQIndex

    @register_index("Flat", r"^Flat$", "Flat", examples=("Flat",))
    def _flat(m, rest, dim):
        return FlatIndex(), 0

    @register_index("IVFPQ", r"^IVFPQ(\d+)x(\d+)$", "IVFPQ<nlists>x<m>",
                    examples=("IVFPQ16x8",))
    def _ivfpq(m, rest, dim, device=None):
        _check_pq_m(int(m.group(2)), dim, m.group(0))
        return IVFPQIndex(n_lists=int(m.group(1)), m=int(m.group(2)),
                          device=device), 0

    @register_index("IVF", r"^IVF(\d+)$",
                    "IVF<nlists>[,Flat] | IVF<nlists>,PQ<m>",
                    examples=("IVF16", "IVF16,Flat", "IVF16,PQ8"))
    def _ivf(m, rest, dim, device=None):
        n_lists = int(m.group(1))
        if rest:
            pq = re.match(r"^PQ(\d+)$", rest[0])
            if pq:
                _check_pq_m(int(pq.group(1)), dim, rest[0])
                return IVFPQIndex(n_lists=n_lists, m=int(pq.group(1)),
                                  device=device), 1
            if rest[0] == "Flat":
                return IVFIndex(n_lists=n_lists, device=device), 1
        return IVFIndex(n_lists=n_lists, device=device), 0

    @register_index("PQ", r"^PQ(\d+)$", "PQ<m>", examples=("PQ8",))
    def _pq(m, rest, dim, device=None):
        _check_pq_m(int(m.group(1)), dim, m.group(0))
        return PQIndex(m=int(m.group(1)), device=device), 0

    @register_index("HNSW", r"^HNSW(\d+)$", "HNSW<m>[,Flat][,EP<k>]",
                    examples=("HNSW8", "HNSW8,EP8"))
    def _hnsw(m, rest, dim, device=None):
        used, ep = 0, 0
        toks = list(rest)
        if toks and toks[0] == "Flat":
            used += 1
            toks = toks[1:]
        if toks:
            em = re.match(r"^EP(\d+)$", toks[0])
            if em:
                ep = int(em.group(1))
                used += 1
        return HNSWIndex(m=int(m.group(1)), ep_clusters=ep,
                         device=device), used

    @register_index(
        "NSG", r"^NSG(\d+)?(?:a(\d+(?:\.\d+)?))?$",
        "NSG[<degree>][a<alpha>][,AH<keep>][,EP<k>][,ND<K>]"
        "[,PQ<m>x8|,SQ8][,Rerank<k>][,HopFused|,HopStaged]"
        "[,Adapt<patience>[c<compact_every>]]",
        examples=("NSG12", "NSG12,EP8", "NSG12,AH0.9,EP8",
                  "NSG12a1.2,ND16", "NSG12,PQ8x8,Rerank32",
                  "NSG12,EP8,SQ8,Rerank32", "NSG12,EP8,HopFused",
                  "NSG12,EP8,Adapt8", "NSG12,EP8,Adapt8c16"))
    def _nsg(m, rest, dim, device=None):
        degree = int(m.group(1)) if m.group(1) else 32
        alpha = float(m.group(2)) if m.group(2) else 1.0
        ep, keep, used = 1, 1.0, 0
        backend, knn_k = "auto", None
        dist_backend, pq_m, rerank = "f32", 0, 64
        hop_backend = "auto"
        patience, compact_every = 0, 0
        for tok in rest:
            em = re.match(r"^EP(\d+)$", tok)
            ah = re.match(r"^AH(0\.\d+|1(?:\.0+)?)$", tok)
            nd = re.match(r"^ND(\d+)?$", tok)
            pq = re.match(r"^PQ(\d+)x8$", tok)
            rr = re.match(r"^Rerank(\d+)$", tok)
            hp = re.match(r"^Hop(Fused|Staged)$", tok)
            ad = re.match(r"^Adapt(\d+)(?:c(\d+))?$", tok)
            if em:
                ep = int(em.group(1))
            elif ah:
                keep = float(ah.group(1))
            elif nd:
                backend = "nndescent"
                if nd.group(1):
                    knn_k = int(nd.group(1))
            elif pq:
                _check_pq_m(int(pq.group(1)), dim, tok)
                dist_backend, pq_m = "pq", int(pq.group(1))
            elif tok == "SQ8":
                dist_backend = "int8"
            elif rr:
                rerank = int(rr.group(1))
            elif hp:
                hop_backend = hp.group(1).lower()
            elif ad:
                patience = int(ad.group(1))
                if patience < 1:
                    raise ValueError(
                        f"Adapt patience must be >= 1 in token {tok!r} "
                        f"(omit the token to disable adaptive termination)")
                if ad.group(2):
                    compact_every = int(ad.group(2))
                    if compact_every < 1:
                        raise ValueError(
                            f"Adapt compact_every must be >= 1 in token "
                            f"{tok!r} (omit the c<n> suffix to disable "
                            f"compaction)")
            else:
                break
            used += 1
        params = IndexParams(
            pca_dim=dim, antihub_keep=keep, ep_clusters=ep,
            graph_degree=degree, alpha=alpha,
            build_knn_k=knn_k if knn_k is not None else degree,
            build_candidates=max(2 * degree, 48), knn_backend=backend,
            dist_backend=dist_backend, pq_m=pq_m, rerank=rerank,
            hop_backend=hop_backend, patience=patience,
            compact_every=compact_every)
        return TunedGraphIndex(params, device=device), used

    # only flag success: a failure above must surface again on retry, not
    # leave the process stuck with an empty registry
    _builtins_registered = True
