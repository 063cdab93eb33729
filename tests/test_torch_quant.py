"""The port's quantized serving path against the reference's.

Inputs are made with numpy from a seed and handed to both packages.

* ``lut_dist`` and ``beam_hop`` in LUT mode add the LUT entries over the
  sub-spaces strictly left to right in both packages (and in the
  reference's Pallas kernels, run in interpret mode), so they must agree
  bit for bit, on float LUTs too.
* The codecs' tables and codes follow the reference op for op; each test
  says whether it asserts bits or a tolerance.
* An index the reference built on integer data (no PCA, one entry point)
  and quantized — int8 by the reference's own ``quantize``, PQ with
  integer codebooks set by hand and the reference's own ``encode`` — is
  carried across with ``index_from_jax_state``: its staged quantized
  search must equal the reference's exactly, ids and dists, with and
  without the exact rerank. (The reference's PQ training itself is held
  to the port's in ``test_pq_codec_fit_from_the_reference_draws``.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels need core first)
from repro.core.flat import recall_at_k
from repro.core.kmeans import _kmeanspp_init
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro.core.quant import Int8Codec as JaxInt8Codec
from repro.core.quant import PQCodec as JaxPQCodec
from repro.core.quant import pq_decode as jax_pq_decode
from repro.core.quant import pq_lut as jax_pq_lut
from repro.core.quant.codec import _sq8_lut as jax_sq8_lut
from repro.kernels.beam_hop import beam_hop_pallas
from repro.kernels.beam_hop import beam_hop_ref as jax_beam_hop_ref
from repro.kernels.lut_dist.lut_dist import lut_dist_pallas
from repro.kernels.lut_dist.ref import lut_dist_ref as jax_lut_dist_ref
from repro_torch.carry import index_from_jax_state
from repro_torch.core.beam_search import beam_search
from repro_torch.core.kmeans import kmeanspp_init
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
from repro_torch.core.quant import (
    Int8Codec, PQCodec, default_pq_m, make_codec, pq_decode, pq_lut,
)
from repro_torch.core.quant.codec import _sq8_lut
from repro_torch.kernels.beam_hop import beam_hop, beam_hop_ref
from repro_torch.kernels.lut_dist import lut_dist, lut_dist_ref

# the carried index: integer data, PCA off, one entry point (the medoid),
# so every distance the search computes is the same number in both packages
INT_PARAMS = dict(pca_dim=32, antihub_keep=0.9, ep_clusters=1,
                  ef_search=32, graph_degree=12, build_knn_k=16,
                  build_candidates=32, knn_backend="exact",
                  finish_backend="host", pq_m=16)
FLOAT_PARAMS = dict(INT_PARAMS, pca_dim=24, ep_clusters=8, pq_m=0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _lut_inputs(rng, q, m, c, n, r):
    lut = (rng.random((q, m, c)) * 10).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    ids = rng.integers(-1, n, (q, r)).astype(np.int32)
    return lut, codes, ids


# ------------------------------------------------------------------ lut_dist
@pytest.mark.parametrize("m,c,r", [(4, 32, 9), (16, 256, 12), (1, 256, 5),
                                   (600, 256, 3)])
def test_lut_dist_bit_exact_to_reference_and_pallas(m, c, r):
    rng = np.random.default_rng(m * c + r)
    lut, codes, ids = _lut_inputs(rng, 7, m, c, 200, r)
    got = lut_dist(*_t(lut, codes, ids)).numpy()
    assert np.isinf(got[ids < 0]).all()
    j = [jnp.asarray(a) for a in (lut, codes, ids)]
    np.testing.assert_array_equal(got, np.asarray(jax_lut_dist_ref(*j)))
    np.testing.assert_array_equal(
        got, np.asarray(lut_dist_pallas(*j, interpret=True)))


def test_lut_dist_sums_left_to_right():
    """A sum whose value depends on the order: 1e8 + 1 + ... + 1 - 1e8 is
    0 left to right in f32 (each +1 is lost), not the exact 4."""
    lut = torch.zeros((1, 6, 2))
    lut[0, 0, 1], lut[0, 5, 1] = 1e8, -1e8
    lut[0, 1:5, 1] = 1.0
    codes = torch.ones((1, 6), dtype=torch.uint8)
    ids = torch.zeros((1, 1), dtype=torch.int32)
    assert float(lut_dist(lut, codes, ids)) == 0.0
    assert float(lut_dist_ref(lut, codes, ids)) == 0.0


# ------------------------------------------------------- beam_hop, LUT mode
def _lut_hop_inputs(rng, nq=12, n=200, m=16, c=256, r=8, ef=16):
    """A mid-search hop state (pool padding, visited marks, inactive lanes,
    -1 graph entries, repeats and pool duplicates) over a LUT and codes;
    LUT entries are small integers, so candidate distances tie often."""
    lut = rng.integers(0, 4, (nq, m, c)).astype(np.float32)
    codes = rng.integers(0, c, (n, m)).astype(np.uint8)
    nbrs = rng.integers(-1, n, (n, r)).astype(np.int32)
    nbrs[:, 1] = nbrs[:, 0]
    pool_i = rng.integers(-1, n, (nq, ef)).astype(np.int32)
    pd = rng.integers(0, 3 * m, (nq, ef)).astype(np.float32)
    pool_d = np.sort(np.where(pool_i >= 0, pd, np.inf), 1).astype(np.float32)
    pool_v = (pool_i < 0) | (rng.random((nq, ef)) < 0.3)
    sel = rng.integers(0, n, nq).astype(np.int32)
    sel[::3] = -1
    nbrs[sel[sel >= 0], 2:5] = pool_i[sel >= 0, :3]
    return sel, nbrs, pool_i, pool_d, pool_v, lut, codes


@pytest.mark.parametrize("dist_backend,m", [("pq", 16), ("int8", 32)])
def test_beam_hop_lut_mode_exact_to_reference(dist_backend, m):
    rng = np.random.default_rng(m)
    inputs = _lut_hop_inputs(rng, m=m)
    got = beam_hop(*_t(*inputs), dist_backend=dist_backend)
    j = [jnp.asarray(a) for a in inputs]
    refs = (jax_beam_hop_ref(*j, dist_backend=dist_backend),
            beam_hop_pallas(*j, dist_backend=dist_backend, interpret=True))
    for want in refs:
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    stats = got[3].numpy()
    assert (stats[::3] == 0).all() and stats[:, 1].sum() > 0


def test_beam_hop_rejects_an_unknown_dist_backend():
    """The backend name is checked where a search enters (``beam_search``,
    here on the fused hop), before any hop runs; the kernel dispatch takes
    what its caller checked, and refuses a card backend on CPU tensors."""
    rng = np.random.default_rng(0)
    sel, nbrs, _, _, _, lut, codes = _t(*_lut_hop_inputs(rng))
    with pytest.raises(ValueError, match="dist_backend"):
        beam_search(lut[:, :, 0], codes.float(), nbrs, sel.clamp_min(0),
                    ef=8, k=4, dist_backend="int4", codes=codes, lut=lut,
                    hop_backend="fused")
    with pytest.raises(RuntimeError, match="CUDA"):
        lut_dist(*_t(*_lut_inputs(rng, 2, 4, 8, 10, 3)), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        beam_hop(*_t(*_lut_hop_inputs(rng)), dist_backend="pq",
                 backend="cuda")


# -------------------------------------------------------------------- codecs
def _float_data(seed, n=3000, d=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 2.0).astype(np.float32)


def test_default_pq_m_matches_the_reference_rule():
    from repro.core.quant import default_pq_m as jax_default_pq_m
    for dim in (600, 96, 32, 31, 1, 7, 768):
        assert default_pq_m(dim) == jax_default_pq_m(dim)
    assert default_pq_m(600) == 300


def test_pq_lut_within_rtol_and_decode_bit_exact():
    """The port adds the squares of a sub-vector's differences as separate
    rounded ops (on the card too). XLA's CPU compiler contracts the
    reference's multiply and add into a fused multiply-add (some entries
    differ in the last bit), so the tables are held to rtol = 1e-6, not
    to bits. The decode is a gather: bits."""
    rng = np.random.default_rng(1)
    for dsub in (2, 8):
        books = rng.standard_normal((32 // dsub, 64, dsub)).astype(np.float32)
        q = rng.standard_normal((9, 32)).astype(np.float32)
        np.testing.assert_allclose(
            pq_lut(*_t(q, books)).numpy(),
            np.asarray(jax_pq_lut(jnp.asarray(q), jnp.asarray(books))),
            rtol=1e-6, atol=0)
        codes = rng.integers(0, 64, (50, 32 // dsub)).astype(np.uint8)
        np.testing.assert_array_equal(
            pq_decode(*_t(codes, books)).numpy(),
            np.asarray(jax_pq_decode(jnp.asarray(codes),
                                     jnp.asarray(books))))


def test_int8_codec_fit_and_encode_bit_exact_lut_within_rtol():
    """Scale, zero-point and codes: bits. The LUT's grid is zero + scale *
    level as a multiply and an add; XLA's CPU compiler fuses the
    reference's into one multiply-add (some grid entries differ in the
    last bit), so the decode and the LUT are held to
    rtol = 1e-6, with atol = 1e-5 for LUT entries near 0: one ulp of a
    grid level g changes (q - g)^2 by ~2|q - g| ulp(g), a large share of
    a small entry."""
    x = _float_data(3)
    x[:, 5] = 1.5                                  # a constant column
    want = JaxInt8Codec().fit(jnp.asarray(x))
    got = Int8Codec().fit(torch.from_numpy(x))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
    q = _float_data(4, n=6)
    qx = np.concatenate([x, q * 3.0])              # values out of range too
    np.testing.assert_array_equal(
        got.encode(torch.from_numpy(qx)).numpy(),
        np.asarray(want.encode(jnp.asarray(qx))))
    np.testing.assert_allclose(
        got.decode(got.encode(torch.from_numpy(x))).numpy(),
        np.asarray(want.decode(want.encode(jnp.asarray(x)))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _sq8_lut(torch.from_numpy(q), got.scale, got.zero).numpy(),
        np.asarray(jax_sq8_lut(jnp.asarray(q), want.scale, want.zero)),
        rtol=1e-6, atol=1e-5)
    assert got.memory_bytes() == want.memory_bytes()
    assert got.code_bytes == want.code_bytes == 32


def test_pq_codec_fit_from_the_reference_draws():
    """The reference's k-means++ seeds per sub-space (its key folding)
    handed in: codebooks within 1e-4, codes agreeing on >= 99%."""
    x = _float_data(5, n=2000)
    m, c = 16, 256
    key = jax.random.PRNGKey(7)
    want = JaxPQCodec(m, c).fit(jnp.asarray(x), key=key)
    sub = x.reshape(x.shape[0], m, -1)
    init = np.stack([np.asarray(_kmeanspp_init(
        jax.random.fold_in(key, j), jnp.asarray(sub[:, j]), c))
        for j in range(m)])
    got = PQCodec(m, c).fit(torch.from_numpy(x),
                            init_centroids=torch.from_numpy(init))
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks), rtol=1e-4,
                               atol=1e-4)
    codes = got.encode(torch.from_numpy(x)).numpy()
    assert codes.dtype == np.uint8
    assert (codes == np.asarray(want.codes)).mean() >= 0.99
    assert got.memory_bytes() == want.memory_bytes()


def test_pq_codec_fit_from_a_generator_is_deterministic():
    x = torch.from_numpy(_float_data(6, n=1500))
    a = PQCodec(8, 64).fit(x, generator=torch.Generator().manual_seed(3))
    b = PQCodec(8, 64).fit(x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.codebooks, b.codebooks)
    assert a.codebooks.shape == (8, 64, 4)
    codes = a.encode(x)
    # the LUT sum of a row's own codes is its squared distance to its
    # reconstruction, to rounding
    q = x[:5]
    adc = lut_dist(a.lut(q), codes, torch.arange(5, dtype=torch.int32)
                   [:, None])[:, 0]
    exact = ((a.decode(codes[:5]) - q) ** 2).sum(1)
    torch.testing.assert_close(adc, exact, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="divide"):
        PQCodec(5).fit(x)
    with pytest.raises(ValueError, match="dist_backend"):
        make_codec("f32", 32)


def test_batched_kmeanspp_init_picks_distinct_rows_per_member():
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, 400, 2)).astype(np.float32))
    cents = kmeanspp_init(torch.Generator().manual_seed(0), x, 50)
    assert cents.shape == (3, 50, 2)
    for b in range(3):
        # every centroid is a row of its own member, and no row twice
        hit = (cents[b][:, None, :] == x[b][None]).all(-1)
        assert bool(hit.any(1).all())
        assert torch.unique(hit.float().argmax(1)).numel() == 50
    again = kmeanspp_init(torch.Generator().manual_seed(0), x[0], 50)
    assert again.shape == (50, 2)


# ------------------------------------------------- quantized beam_search
def test_beam_search_quantized_fused_equals_staged():
    rng = np.random.default_rng(9)
    n, m, nq = 300, 16, 20
    codes = torch.from_numpy(rng.integers(0, 256, (n, m)).astype(np.uint8))
    lut = torch.from_numpy(rng.random((nq, m, 256)).astype(np.float32))
    nbrs = torch.from_numpy(rng.integers(-1, n, (n, 10)).astype(np.int32))
    entry = torch.from_numpy(rng.integers(0, n, nq).astype(np.int32))
    q = torch.zeros((nq, 4))
    db = torch.zeros((n, 4))
    kw = dict(ef=16, k=10, with_stats=True, dist_backend="pq", codes=codes,
              lut=lut)
    fd, fi, fs = beam_search(q, db, nbrs, entry, hop_backend="fused", **kw)
    sd, si, ss = beam_search(q, db, nbrs, entry, hop_backend="staged", **kw)
    assert torch.equal(fd, sd) and torch.equal(fi, si)
    for a, b in zip(fs, ss):
        assert torch.equal(a, b)
    assert int(fs.hops.sum()) > nq
    with pytest.raises(ValueError, match="codes and lut"):
        beam_search(q, db, nbrs, entry, ef=8, k=4, dist_backend="int8")


# ------------------------------------------------------ the index, carried
@pytest.fixture(scope="module")
def int_case():
    """The reference's f32 index on integer data, its integer queries and
    its two codecs: int8 from ``quantize``; PQ with integer codebooks in
    [-8, 8] (so every LUT entry is an integer in both packages) and codes
    from the reference's ``encode``."""
    rng = np.random.default_rng(11)
    data = rng.integers(-8, 9, (2000, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, (40, 32)).astype(np.float32)
    idx = JaxTunedGraphIndex(JaxIndexParams(**INT_PARAMS)).fit(
        jnp.asarray(data))
    pq = JaxPQCodec(16, 256)
    pq.codebooks = jnp.asarray(
        rng.integers(-8, 9, (16, 256, 2)).astype(np.float32))
    codecs = {"pq": (pq, pq.encode(idx.base))}
    idx.quantize("int8")
    codecs["int8"] = (idx.codec, idx.codes)
    return idx, queries, codecs


def _quantized(int_case, backend):
    """The reference's index with ``backend``'s codec attached, and the
    port's index carried across from its state."""
    idx, _, codecs = int_case
    idx.codec, idx.codes = codecs[backend]
    idx.codec_backend = backend
    state = idx.state_dict()
    state["arrays"] = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return idx, index_from_jax_state(state, device="cpu")


@pytest.mark.parametrize("rerank", [0, 64])
@pytest.mark.parametrize("backend", ["pq", "int8"])
def test_carried_quantized_index_searches_exactly_like_the_reference(
        int_case, backend, rerank):
    jax_index, port = _quantized(int_case, backend)
    queries = int_case[1]
    assert port.codec_backend == backend
    assert torch.equal(port.codes, torch.from_numpy(
        np.array(jax_index.codes)))
    kw = dict(ef=32, rerank=rerank, dist_backend=backend,
              hop_backend="staged")
    jd, ji = jax_index.search(jnp.asarray(queries), 10, **kw)
    pd, pi = port.search(torch.from_numpy(queries), 10, **kw)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert port.search_stats() == jax_index.search_stats()
    assert port.memory_bytes() == jax_index.memory_bytes()
    # the port's fused hop is its staged hop, bit for bit
    fd, fi = port.search(torch.from_numpy(queries), 10,
                         **dict(kw, hop_backend="fused"))
    assert torch.equal(fd, pd) and torch.equal(fi, pi)


@pytest.mark.parametrize("backend", ["pq", "int8"])
def test_quantized_state_round_trips(int_case, backend):
    _, port = _quantized(int_case, backend)
    q = torch.from_numpy(int_case[1])
    d1, i1 = port.search(q, 10, dist_backend=backend)
    again = TunedGraphIndex.from_state(port.state_dict(), device="cpu")
    assert again.codec_backend == backend
    assert torch.equal(again.codes, port.codes)
    d2, i2 = again.search(q, 10, dist_backend=backend)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    # the reference loads the port's quantized state and searches alike
    back = JaxTunedGraphIndex.from_state(port.state_dict())
    jd, ji = back.search(jnp.asarray(int_case[1]), 10, dist_backend=backend,
                         hop_backend="staged")
    np.testing.assert_array_equal(np.asarray(ji), i1.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d1.numpy())


def test_search_requantizes_for_another_backend(int_case):
    """A PQ index asked for int8 fits the int8 codec on the spot; the int8
    fit is deterministic, so it is the reference's, and so is the search."""
    jax_index, port = _quantized(int_case, "pq")
    queries = int_case[1]
    d, i = port.search(torch.from_numpy(queries), 10, dist_backend="int8")
    assert port.codec_backend == "int8" and port.codes.shape == (1800, 32)
    jax_index, _ = _quantized(int_case, "int8")
    assert torch.equal(port.codes, torch.from_numpy(
        np.array(jax_index.codes)))
    jd, ji = jax_index.search(jnp.asarray(queries), 10,
                              dist_backend="int8", hop_backend="staged")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.fixture(scope="module")
def float_reference(ann_data):
    """The reference's f32 index over the shared float data, and its
    recall@10."""
    ref = JaxTunedGraphIndex(JaxIndexParams(**FLOAT_PARAMS)).fit(
        ann_data["data"])
    _, ji = ref.search(ann_data["queries"], 10)
    return float(recall_at_k(np.asarray(ji), ann_data["true_i"]))


@pytest.mark.parametrize("backend", ["pq", "int8"])
def test_port_quantized_fit_keeps_reference_recall(ann_data,
                                                   float_reference, backend):
    """The port builds and quantizes its own index (its own k-means++
    draws): recall@10 after the exact rerank within 0.02 of the
    reference's f32 index at the same params; the fit records the
    quantize stage."""
    params = dict(FLOAT_PARAMS, dist_backend=backend)
    data = np.array(ann_data["data"])
    idx = TunedGraphIndex(IndexParams(**params), device="cpu").fit(
        torch.from_numpy(data), torch.Generator().manual_seed(0))
    assert idx.codec_backend == backend and "quantize" in idx.stage_seconds
    assert set(idx.quantize_seconds) == {"fit", "encode"}
    d, i = idx.search(torch.from_numpy(np.array(ann_data["queries"])), 10)
    r_port = float(recall_at_k(i.numpy(), ann_data["true_i"]))
    assert r_port >= float_reference - 0.02, (r_port, float_reference)
    assert bool(torch.isfinite(d).all())
    assert (d.numpy()[:, 1:] >= d.numpy()[:, :-1]).all()
