"""The port's unified Index API against the reference's: SearchParams, the
registry, the factory grammar (every example and every error), the spec
contract at the reference's recall floors, rebuild-free params, the
index-agnostic tuner and custom registration.

Inputs are made with numpy from a seed (the reference's clustered recipe:
Zipf-weighted centers, a decaying spectrum) and given to both packages.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels need core first)
from repro.core import index_api as jax_api
from repro_torch.core import index_api as api
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.index_api import (
    Index, SearchParams, available_factories, build_index, list_index_specs,
    param_or, parse_spec, register_index,
)
from repro_torch.core.persist import index_from_state, index_state
from repro_torch.core.tuning import SearchParamsObjective, Study, TPESampler
from repro_torch.core.tuning.space import SearchSpace

BUILTINS = ("Flat", "IVFPQ", "IVF", "PQ", "HNSW", "NSG")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other made this module's many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(seed, n, d, k):
    rng = np.random.default_rng(seed)
    scales = 0.95 ** np.arange(d)
    centers = rng.standard_normal((k, d)) * scales
    w = 1.0 / (1.0 + np.arange(k))
    assign = rng.choice(k, size=n, p=w / w.sum())
    return (centers[assign] + rng.standard_normal((n, d)) * scales).astype(
        np.float32)


@pytest.fixture(scope="module")
def small_db():
    data = _clustered(7, 600, 32, 8)
    rng = np.random.default_rng(8)
    queries = data[rng.integers(0, 600, 24)] + 0.05 * rng.standard_normal(
        (24, 32)).astype(np.float32)
    data, queries = torch.from_numpy(data), torch.from_numpy(queries)
    _, true_i = FlatIndex(data).search(queries, 10)
    return data, queries, true_i


def recall_floor(spec: str) -> float:
    """The reference's per-family recall@10 floors (test_index_api.py)."""
    if spec.startswith("PCA"):
        return 0.55 if spec == "PCA24,Flat" else 0.50
    if spec == "Flat":
        return 0.999
    if "Rerank" in spec:
        return 0.85
    if "PQ" in spec:
        return 0.30
    if "AH" in spec:
        return 0.80
    if spec.startswith("IVF"):
        return 0.85
    return 0.90


MAXED = SearchParams(ef_search=128, nprobe=16)
SPECS = [s for examples in available_factories().values() for s in examples]
SPECS += ["PCA24,Flat", "PCA24,IVF16", "PCA24,HNSW8", "PCA24,NSG12,EP8"]


# ------------------------------------------------------------ SearchParams
def test_search_params_fields_and_resolve_match_the_reference():
    mine = [f.name for f in dataclasses.fields(SearchParams)]
    assert mine == [f.name for f in dataclasses.fields(jax_api.SearchParams)]
    p = SearchParams(nprobe=4)
    assert p.resolve("nprobe", 9) == 4 and p.resolve("ef_search", 9) == 9
    assert param_or(None, "nprobe", 3) == 3
    assert param_or(p, "nprobe", 3) == 4
    assert hash(p) == hash(SearchParams(nprobe=4))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.nprobe = 2


def test_registry_equals_the_references():
    mine, theirs = list_index_specs(), jax_api.list_index_specs()
    assert [k for k in mine if k in BUILTINS] == \
        [k for k in theirs if k in BUILTINS] == list(BUILTINS)
    assert {k: mine[k] for k in BUILTINS} == {k: theirs[k] for k in BUILTINS}
    assert available_factories() == {
        k: v for k, v in jax_api.available_factories().items()
        if k in BUILTINS}


# ------------------------------------------------------------------ parse
def _summary(index):
    """What a parse decides: the family and its construction knobs."""
    name = type(index).__name__
    if name == "TunedGraphIndex":
        return name, dataclasses.asdict(index.params)
    keys = ("n_lists", "nprobe", "m", "ep_clusters", "ef_s", "ef_c")
    out = {k: getattr(index, k) for k in keys if hasattr(index, k)}
    if name == "PQIndex":
        out["n_centroids"] = index.n_centroids
    return name, out


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_the_references(spec):
    pca, idx = parse_spec(spec, 32, device="cpu")
    jpca, jidx = jax_api.parse_spec(spec, 32)
    assert pca == jpca
    assert _summary(idx) == _summary(jidx)


@pytest.mark.parametrize("spec", [
    "Bogus32", "Flat,Flat", "PCA8", "", " , ", "IVFPQ16x7", "PQ7",
    "IVF16,PQ7", "NSG12,PQ7x8", "NSG12,Adapt0", "NSG12,EP8,Adapt8c0",
    "IVF16,Flat,Flat", "HNSW8,EP8,Flat", "NSG12,EP8,Bogus"])
def test_parse_errors_equal_the_references(spec):
    with pytest.raises(ValueError) as mine:
        parse_spec(spec, 32, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_api.parse_spec(spec, 32)
    # the no-match message lists the whole registry: compare its head
    cut = lambda e: re.sub(r"known components: .*", "", str(e.value))
    assert cut(mine) == cut(theirs)


def test_registry_errors_through_build_index():
    data = torch.randn(64, 8)
    with pytest.raises(ValueError, match="no registered index"):
        build_index("Bogus32", data, device="cpu")
    with pytest.raises(ValueError, match="trailing tokens"):
        build_index("Flat,Flat", data, device="cpu")
    with pytest.raises(ValueError, match="PCA prefix but no index"):
        build_index("PCA8", data, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        build_index("PQ3", data, device="cpu")


def test_parse_spec_defers_fit():
    pca_dim, idx = parse_spec("PCA8,NSG16,EP4", dim=32, device="cpu")
    assert pca_dim == 8
    assert idx.params.pca_dim == 8          # NSG builds in the reduced space
    assert idx.params.ep_clusters == 4
    assert idx.graph is None


def test_build_index_overrides_reach_the_params(small_db):
    data, queries, _ = small_db
    idx = build_index("NSG12,EP4", data, device="cpu", knn_backend="exact",
                      finish_backend="host", rerank=16, patience=4)
    p = idx.params
    assert (p.knn_backend, p.finish_backend, p.rerank, p.patience) == \
        ("exact", "host", 16, 4)
    flat = build_index("Flat", data, device="cpu", rerank=16)  # no params
    assert isinstance(flat, FlatIndex)


# --------------------------------------------------------------- contract
@pytest.fixture(scope="module")
def built(small_db):
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = build_index(
                spec, small_db[0], generator=torch.Generator().manual_seed(0),
                device="cpu")
        return cache[spec]
    return get


@pytest.mark.parametrize("spec", SPECS)
def test_spec_contract(spec, small_db, built):
    data, queries, true_i = small_db
    floor = recall_floor(spec)
    idx = built(spec)
    assert isinstance(idx, Index)
    assert idx.spec == spec
    assert 0 < idx.ntotal <= data.shape[0]
    assert idx.dim == data.shape[1]
    assert isinstance(idx.search_params_space(), SearchSpace)
    assert idx.memory_bytes() > 0
    d, i = idx.search(queries, 10)
    assert d.shape == i.shape == (queries.shape[0], 10)
    assert i.dtype == torch.int32 and int(i.max()) < data.shape[0]
    assert recall_at_k(i, true_i) >= floor
    d2, i2 = idx.search(queries, 10, MAXED)
    assert recall_at_k(i2, true_i) >= floor


@pytest.mark.parametrize("spec", ["NSG12,EP8", "HNSW8", "IVF16", "PQ8",
                                  "PCA24,IVF16"])
def test_search_space_names_equal_the_references(spec, small_db, built):
    jidx = jax_api.build_index(spec, jax.numpy.asarray(small_db[0].numpy()))
    assert built(spec).search_params_space().names() == \
        jidx.search_params_space().names()


def test_params_change_behavior_without_refit(small_db, built):
    _, queries, true_i = small_db
    idx = built("IVF16")
    r1 = recall_at_k(idx.search(queries, 10, SearchParams(nprobe=1))[1],
                     true_i)
    r16 = recall_at_k(idx.search(queries, 10, SearchParams(nprobe=16))[1],
                      true_i)
    assert r1 <= r16
    assert r16 >= 0.999          # probing every list is exact
    g = built("NSG12,EP8")
    _, lo = g.search(queries, 10, SearchParams(ef_search=10))
    _, hi = g.search(queries, 10, SearchParams(ef_search=10), ef=128)
    assert recall_at_k(hi, true_i) >= recall_at_k(lo, true_i)
    assert torch.equal(hi, g.search(queries, 10, ef=128)[1])  # keyword wins


def test_generic_tuner_is_index_agnostic(small_db):
    data, queries, _ = small_db
    for spec in ("NSG12,EP4", "IVF16"):
        obj = SearchParamsObjective(spec, data, queries, k=10,
                                    recall_floor=0.8, qps_repeats=1,
                                    device="cpu")
        assert len(obj.space.names()) >= 1
        study = Study(obj.space, TPESampler(seed=0, n_startup=2))
        study.optimize(obj.single_objective, n_trials=4)
        best = study.best_trial
        assert best.feasible
        assert set(best.params) <= {"ef_search", "nprobe", "mode",
                                    "chunk", "patience"}
        assert len(obj.eval_log) == 4


def test_custom_registration_round_trips(small_db):
    class DoubleFlat(FlatIndex):
        """Toy custom family: third-party indexes are one decorator."""

    try:
        @register_index("DoubleFlat", r"^DoubleFlat$")
        def _build(m, rest, dim):
            return DoubleFlat(), 0

        data, queries, true_i = small_db
        idx = build_index("DoubleFlat", data, device="cpu")
        assert isinstance(idx, DoubleFlat)
        assert recall_at_k(idx.search(queries, 10)[1], true_i) >= 0.999
        back = index_from_state(index_state(idx), device="cpu")
        assert type(back) is DoubleFlat
        assert torch.equal(back.search(queries, 10)[1],
                           idx.search(queries, 10)[1])
    finally:
        api._REGISTRY.pop("DoubleFlat", None)


# ------------------------------------------------------------ HNSW surface
def test_hnsw_search_passes_mode_through(small_db, built, monkeypatch):
    import repro_torch.core.hnsw as hnsw_mod
    _, queries, _ = small_db
    seen = {}
    orig = hnsw_mod.beam_search

    def spy(*args, **kw):
        seen.update(kw)
        return orig(*args, **kw)

    monkeypatch.setattr(hnsw_mod, "beam_search", spy)
    built("HNSW8").search(queries, 5, SearchParams(mode="fori",
                                                   ef_search=32))
    assert seen["mode"] == "fori"
    assert seen["ef"] == 32
    assert seen["layout"] == "batched"


def test_hnsw_ep_spec_replaces_hierarchy(small_db, built):
    _, queries, true_i = small_db
    idx = built("HNSW8,EP8")
    assert idx.eps is not None and idx.eps.centroids.shape[0] == 8
    entries = idx.entry_points(queries)
    assert set(entries.tolist()) <= set(idx.eps.member_ids.tolist())
    assert recall_at_k(idx.search(queries, 10)[1], true_i) >= 0.90


def test_recall_at_k_divides_by_requested_k():
    true = torch.tensor([[1, 2, 3, 4, 5, 6]])
    assert recall_at_k(torch.tensor([[1, 2, 3]]), true) == 1.0
    assert recall_at_k(torch.tensor([[4, 5, 6]]), true) == 0.0
    assert recall_at_k(torch.tensor([[1, 2, 9]]), true) == \
        pytest.approx(2 / 3)
