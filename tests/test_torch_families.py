"""The port's IVF, PQ, IVF-PQ and HNSW families and the paper's batching
algorithms against the reference's, on the same numpy inputs.

* Fits: the reference's k-means++ draws are handed in (``init_centroids``
  / ``pq_init_centroids``), on integer data whose clusters are far apart,
  so every sum the k-means makes is exact in both packages: centroids,
  posting lists, codebooks and codes must be equal exactly.
* HNSW: the host build is the reference's numpy code, so the layers and
  the entry node must be equal id for id at one seed; the batched device
  descent must land on ``_descend_upper``'s entries on integer data.
* Top-k ties: on tied integer data the families return ids in the
  reference's ``lax.top_k`` order (lower candidate position first).
* Algorithms 1 and 2 (``core/batching.py``) on a carried index equal the
  reference's exactly on integer data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels need core first)
from repro.core.batching import search_grouped as jax_search_grouped
from repro.core.batching import search_naive as jax_search_naive
from repro.core.hnsw import HNSWIndex as JaxHNSWIndex
from repro.core.hnsw import _descend_upper
from repro.core.ivf import IVFIndex as JaxIVFIndex
from repro.core.ivfpq import IVFPQIndex as JaxIVFPQIndex
from repro.core.kmeans import _kmeanspp_init
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro.core.pq import PQIndex as JaxPQIndex
from repro_torch.carry import index_from_jax_state
from repro_torch.core.batching import search_grouped, search_naive
from repro_torch.core.distances import smallest_k
from repro_torch.core.hnsw import HNSWIndex, descend_upper
from repro_torch.core.index_api import SearchParams
from repro_torch.core.ivf import IVFIndex, posting_lists
from repro_torch.core.ivfpq import IVFPQIndex
from repro_torch.core.pq import PQIndex, adc_scan

KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other made this module's many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _far_clusters(seed, n=720, d=32, k=8, spread=2):
    """Integer rows around k centers 64 apart: no row is near a cluster
    boundary, so assignments never hinge on a rounding."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-4, 5, (k, d)) * 64
    assign = np.arange(n) % k
    rng.shuffle(assign)
    x = centers[assign] + rng.integers(-spread, spread + 1, (n, d))
    q = centers[rng.integers(0, k, 24)] + rng.integers(-spread, spread + 1,
                                                       (24, d))
    return x.astype(np.float32), q.astype(np.float32)


def _prototypes(seed, n=720, d=32, m=8, c=16):
    """Integer rows each of whose m sub-vectors is one of c distinct
    prototypes (multiples of 8) of its sub-space: k-means++ seeds each
    prototype once, so every codebook is its sub-space's prototypes."""
    rng = np.random.default_rng(seed)
    dsub = d // m
    protos = np.stack([rng.permutation(64)[:c * dsub].reshape(c, dsub)
                       for _ in range(m)]) * 8                # (m, c, dsub)
    pick = rng.integers(0, c, (n, m))
    x = protos[np.arange(m)[None, :], pick].reshape(n, d)
    q = protos[np.arange(m)[None, :], rng.integers(0, c, (24, m))]
    return x.astype(np.float32), q.reshape(24, d).astype(np.float32)


# --------------------------------------------------------------------- IVF
@pytest.fixture(scope="module")
def ivf_pair():
    x, q = _far_clusters(0)
    want = JaxIVFIndex(n_lists=8).fit(jnp.asarray(x), key=KEY)
    init = _np(_kmeanspp_init(KEY, jnp.asarray(x), 8))
    got = IVFIndex(n_lists=8, device="cpu").fit(_t(x), init_centroids=init)
    return want, got, x, q


def test_ivf_fit_equals_the_reference_with_its_draws(ivf_pair):
    want, got, _, _ = ivf_pair
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  _np(want.centroids))
    np.testing.assert_array_equal(got.lists.numpy(), _np(want.lists))
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_ivf_search_equals_the_reference(ivf_pair, nprobe):
    want, got, _, q = ivf_pair
    p = SearchParams(nprobe=nprobe)
    wd, wi = want.search(jnp.asarray(q), 10, p)
    gd, gi = got.search(_t(q), 10, p)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gd.numpy(), _np(wd))


def test_posting_lists_fill_in_id_order():
    assign = torch.tensor([2, 0, 2, 1, 0, 2, 2], dtype=torch.int32)
    lists, order, slot = posting_lists(assign, 4)
    assert lists.tolist() == [[1, 4, -1, -1], [3, -1, -1, -1],
                              [0, 2, 5, 6], [-1, -1, -1, -1]]
    assert (lists[assign[order].long(), slot] == order).all()


# ---------------------------------------------------------------------- PQ
@pytest.fixture(scope="module")
def pq_pair():
    x, q = _prototypes(1)
    m, c = 8, 16
    want = JaxPQIndex(m=m, n_centroids=c).fit(jnp.asarray(x), key=KEY)
    sub = x.reshape(x.shape[0], m, -1)
    init = np.stack([_np(_kmeanspp_init(jax.random.fold_in(KEY, j),
                                        jnp.asarray(sub[:, j]), c))
                     for j in range(m)])
    got = PQIndex(m=m, n_centroids=c, device="cpu").fit(
        _t(x), init_centroids=init)
    return want, got, x, q


def test_pq_fit_equals_the_reference_with_its_draws(pq_pair):
    want, got, _, _ = pq_pair
    np.testing.assert_array_equal(got.codebooks.numpy(),
                                  _np(want.codebooks))
    np.testing.assert_array_equal(got.codes.numpy(), _np(want.codes))
    assert got.codes.dtype == torch.uint8
    assert got.memory_bytes() == want.memory_bytes()
    assert got.dim == want.dim and got.ntotal == want.ntotal


def test_pq_search_equals_the_reference(pq_pair):
    """Rows share prototypes, so ADC distances tie in bulk: the ids must
    come in the reference's order (lower id first)."""
    want, got, _, q = pq_pair
    wd, wi = want.search(jnp.asarray(q), 10)
    gd, gi = got.search(_t(q), 10)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gd.numpy(), _np(wd))


@pytest.mark.parametrize("pairs", [1, 7, 100, 1 << 24])
def test_adc_scan_chunks_equal_one_pass(pq_pair, monkeypatch, pairs):
    """The running top-k across chunks of any size equals one chunk."""
    import repro_torch.core.pq as pq_mod
    _, got, _, q = pq_pair
    lut = torch.from_numpy(np.random.default_rng(4).integers(
        0, 3, (5, 8, 16)).astype(np.float32))
    whole = adc_scan(lut, got.codes, 12)
    monkeypatch.setattr(pq_mod, "SCAN_PAIRS", pairs)
    part = adc_scan(lut, got.codes, 12)
    assert torch.equal(whole[0], part[0]) and torch.equal(whole[1], part[1])


# ------------------------------------------------------------------ IVF-PQ
@pytest.fixture(scope="module")
def ivfpq_pair():
    """Coarse clusters of prototype rows, each row beside its negation in
    the same cluster: every cluster mean is its integer center, so every
    residual is an integer prototype and every sum exact in both
    packages (the reference's 256 codewords outnumber the distinct
    residuals; its seeds repeat some, and means of repeats stay exact)."""
    xp, qp = _prototypes(2, n=360)
    rng = np.random.default_rng(5)
    centers = rng.integers(-4, 5, (4, 32)).astype(np.float32) * 1024
    group = np.tile(np.arange(360) % 4, 2)
    x = np.concatenate([xp, -xp]) + centers[group]
    q = qp + centers[rng.integers(0, 4, qp.shape[0])]
    want = JaxIVFPQIndex(n_lists=4, m=8).fit(jnp.asarray(x), key=KEY)
    init = _np(_kmeanspp_init(KEY, jnp.asarray(x), 4))
    cents = _np(want.centroids)
    assign = ((x[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    res = (x - cents[assign]).reshape(x.shape[0], 8, -1)
    pkey = jax.random.fold_in(KEY, 1)
    c = min(256, x.shape[0])
    pq_init = np.stack([_np(_kmeanspp_init(jax.random.fold_in(pkey, j),
                                           jnp.asarray(res[:, j]), c))
                        for j in range(8)])
    got = IVFPQIndex(n_lists=4, m=8, device="cpu").fit(
        _t(x), init_centroids=init, pq_init_centroids=pq_init)
    return want, got, x, q


def test_ivfpq_fit_equals_the_reference_with_its_draws(ivfpq_pair):
    want, got, _, _ = ivfpq_pair
    np.testing.assert_array_equal(got.centroids.numpy(),
                                  _np(want.centroids))
    np.testing.assert_array_equal(got.lists.numpy(), _np(want.lists))
    np.testing.assert_array_equal(got.pq.codebooks.numpy(),
                                  _np(want.pq.codebooks))
    np.testing.assert_array_equal(got.pq.codes.numpy(), _np(want.pq.codes))
    np.testing.assert_array_equal(got.list_codes.numpy(),
                                  _np(want.list_codes))
    assert got.list_codes.dtype == torch.int32
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("nprobe", [1, 2, 4])
def test_ivfpq_search_equals_the_reference(ivfpq_pair, nprobe):
    want, got, _, q = ivfpq_pair
    p = SearchParams(nprobe=nprobe)
    wd, wi = want.search(jnp.asarray(q), 10, p)
    gd, gi = got.search(_t(q), 10, p)
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_allclose(gd.numpy(), _np(wd), rtol=1e-6)


# -------------------------------------------------------------------- HNSW
@pytest.fixture(scope="module")
def hnsw_pair():
    rng = np.random.default_rng(6)
    x = rng.integers(-6, 7, (600, 32)).astype(np.float32)
    q = rng.integers(-6, 7, (24, 32)).astype(np.float32)
    want = JaxHNSWIndex(m=8, seed=0).fit(jnp.asarray(x))
    got = HNSWIndex(m=8, seed=0, device="cpu").fit(_t(x))
    return want, got, x, q


def test_hnsw_layers_equal_the_reference_at_one_seed(hnsw_pair):
    want, got, _, _ = hnsw_pair
    assert len(got.layers) == len(want.layers) >= 2
    for a, b in zip(got.layers, want.layers):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.node_level, want.node_level)
    assert got.entry == want.entry
    assert got.memory_bytes() == want.memory_bytes()
    assert torch.equal(got._upper, _t(_np(want._upper)))


def test_hnsw_descent_equals_the_reference(hnsw_pair):
    want, got, _, q = hnsw_pair
    wd = _np(_descend_upper(jnp.asarray(q), want._db, want._upper,
                            jnp.int32(want.entry)))
    gd = descend_upper(_t(q), got._db, got._upper, got.entry)
    np.testing.assert_array_equal(gd.numpy(), wd)
    assert torch.equal(got.entry_points(_t(q)), gd)


@pytest.mark.parametrize("ef", [16, 48])
def test_hnsw_search_equals_the_reference(hnsw_pair, ef):
    want, got, _, q = hnsw_pair
    wd, wi = want.search(jnp.asarray(q), 10, ef=ef)
    gd, gi = got.search(_t(q), 10, SearchParams(ef_search=ef))
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gd.numpy(), _np(wd))


def test_hnsw_single_layer_graph_starts_at_the_entry():
    x = np.arange(32 * 6, dtype=np.float32).reshape(6, 32)
    got = HNSWIndex(m=64, device="cpu").fit(_t(x))
    want = JaxHNSWIndex(m=64).fit(jnp.asarray(x))
    assert len(got.layers) == len(want.layers)
    np.testing.assert_array_equal(got.entry_points(_t(x[:3])).numpy(),
                                  _np(want.entry_points(jnp.asarray(x[:3]))))


# ------------------------------------------------------------ top-k ties
def test_smallest_k_keeps_lax_top_k_order_on_ties():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 4, (6, 40)).astype(np.float32)
    d[0, 5:] = np.inf
    d[1, :] = 0.0
    d[2, 3] = -0.0
    for k in (1, 6, 40):
        gv, gp = smallest_k(_t(d), k)
        nv, npos = jax.lax.top_k(-jnp.asarray(d), k)
        np.testing.assert_array_equal(gp.numpy(), _np(npos))
        np.testing.assert_array_equal(gv.numpy(), -_np(nv))
        assert gp.dtype == torch.int32


def test_ivf_ties_come_in_candidate_order():
    """Duplicate rows in several lists tie exactly: both packages must
    return them in candidate position order."""
    rng = np.random.default_rng(8)
    base = rng.integers(-1, 2, (60, 8)) * 32
    x = np.concatenate([base, base, base]).astype(np.float32)
    q = base[:6].astype(np.float32)
    want = JaxIVFIndex(n_lists=6).fit(jnp.asarray(x), key=KEY)
    init = _np(_kmeanspp_init(KEY, jnp.asarray(x), 6))
    got = IVFIndex(n_lists=6, device="cpu").fit(_t(x), init_centroids=init)
    for nprobe in (1, 6):
        _, wi = want.search(jnp.asarray(q), 9, SearchParams(nprobe=nprobe))
        _, gi = got.search(_t(q), 9, SearchParams(nprobe=nprobe))
        np.testing.assert_array_equal(gi.numpy(), _np(wi))


# ------------------------------------------------ Algorithms 1 and 2
@pytest.fixture(scope="module")
def batching_pair():
    rng = np.random.default_rng(9)
    x = rng.integers(-8, 9, (700, 32)).astype(np.float32)
    q = rng.integers(-8, 9, (20, 32)).astype(np.float32)
    params = dict(pca_dim=32, antihub_keep=0.9, ep_clusters=4,
                  ef_search=24, graph_degree=12, build_knn_k=12,
                  build_candidates=32, knn_backend="exact",
                  finish_backend="host")
    want = JaxTunedGraphIndex(JaxIndexParams(**params)).fit(jnp.asarray(x))
    state = want.state_dict()
    state["arrays"] = {k: _np(v) for k, v in state["arrays"].items()}
    return want, index_from_jax_state(state, device="cpu"), q


@pytest.mark.parametrize("alg", ["naive", "grouped"])
def test_batching_algorithms_equal_the_reference(batching_pair, alg):
    want, got, q = batching_pair
    fj, fp = ((jax_search_naive, search_naive) if alg == "naive"
              else (jax_search_grouped, search_grouped))
    wd, wi = fj(want, jnp.asarray(q), 10)
    gd, gi = fp(got, _t(q), 10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert gi.dtype == np.int64 and gd.dtype == np.float32


def test_algorithms_one_and_two_agree(batching_pair):
    _, got, q = batching_pair
    a = search_naive(got, _t(q), 10)
    b = search_grouped(got, _t(q), 10)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])


@pytest.mark.parametrize("elems", [1, 4096, 1 << 28])
def test_pq_lut_chunks_give_the_same_table(monkeypatch, elems):
    """pq_lut bounds its difference tensor by query chunks: any chunking
    gives the one-pass table bit for bit."""
    import repro_torch.core.quant.codec as codec_mod
    rng = np.random.default_rng(10)
    q = _t(rng.standard_normal((37, 32)).astype(np.float32))
    books = _t(rng.standard_normal((8, 16, 4)).astype(np.float32))
    whole = codec_mod.pq_lut(q, books)
    monkeypatch.setattr(codec_mod, "LUT_CHUNK_ELEMS", elems)
    assert torch.equal(codec_mod.pq_lut(q, books), whole)
    assert codec_mod.pq_lut(q[:0], books).shape == (0, 8, 16)
