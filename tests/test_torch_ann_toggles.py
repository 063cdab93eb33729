"""The sharded tier's ANN toggles (``ANN_BF16_BASE``: bf16 database rows;
``ANN_PRENORM``: the ``|q|^2 + |x|^2 - 2 x.q`` distance over norms kept at
build time; with ``ANN_TIGHT_BUDGET``) against the reference, and the
compacted search's ``buckets=``.

The reference's ``shard_map`` programs do not trace under this JAX, but its
per-shard body (``_stream_local``) and its ``StreamedShardedIndex`` run
whole, under every toggle. So its streamed tier is fitted once per row
type and carried across (``repro_torch.carry``), and the port's per-shard
step, its streamed tier and its mesh tier (4 shards on a 2 x 4 mesh of
``[cpu] * 8``) are held to it.

Tolerances: on integer data with |x| <= 16 every comparison is exact —
bf16 holds each coordinate, each |x|^2 is an integer far below 2^24, and
so every distance in either form. On float data the ids must be equal and
the distances agree to 4e-6 of |q|^2 + |x|^2: the prenorm form subtracts
two terms of that size, each rounded in its own package's order (a few
units of 2^-24 of it), so its result carries that absolute error however
small the distance is.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro import flags as jax_flags
from repro.checkpoint.checkpointer import read_payload as jax_read_payload
from repro.checkpoint.checkpointer import write_payload as jax_write_payload
from repro.core import IndexParams as JaxIndexParams
from repro.core.beam_search import beam_search_compacted as \
    jax_beam_search_compacted
from repro.core.build import derive_local as jax_derive_local
from repro.core.distributed import ShardedIndexArrays as JaxArrays
from repro.core.distributed import StreamedShardedIndex as JaxStreamed
from repro.core.distributed import _stream_local as jax_stream_local
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro.data import clustered_vectors as jax_clustered_vectors
from repro_torch import flags
from repro_torch.carry import sharded_index_from_jax, \
    streamed_sharded_index_from_jax
from repro_torch.checkpoint.checkpointer import read_payload, write_payload
from repro_torch.core.beam_search import beam_search_compacted
from repro_torch.core.build.shardlocal import derive_local
from repro_torch.core.distributed import ShardedIndex, \
    StreamedShardedIndex, _local_beam, row_norms
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.pipeline import IndexParams
from repro_torch.data import clustered_vectors, queries_like
from repro_torch.kernels.beam_hop import beam_hops_ref
from repro_torch.kernels.gather_dist import gather_dist, gather_dist_ref
from repro_torch.kernels.gather_dist.ref import fma32, lanes_reduce
from repro_torch.launch.mesh import make_host_mesh

CPU = torch.device("cpu")
N, D, S, K, EF = 480, 24, 4, 10, 24
FIELDS = ("base", "neighbors", "global_ids", "centroids", "members",
          "base_norms")
PARAMS = dict(antihub_keep=1.0, ep_clusters=4, ef_search=EF,
              graph_degree=10, build_knn_k=10, build_candidates=20,
              knn_backend="exact", finish_backend="host")
COMBOS = [(False, False), (True, False), (False, True), (True, True)]
COMBO_IDS = ["f32", "bf16", "prenorm", "bf16+prenorm"]
FLOAT_TOL = 4e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def toggles(bf16=False, prenorm=False, tight=False):
    """Set the three toggles in both packages, restore them after."""
    names = ("ANN_BF16_BASE", "ANN_PRENORM", "ANN_TIGHT_BUDGET")
    saved = [(m, n, getattr(m, n)) for m in (flags, jax_flags)
             for n in names]
    for m in (flags, jax_flags):
        for n, v in zip(names, (bf16, prenorm, tight)):
            setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _np(a):
    return np.asarray(a)


def _t(a):
    """A reference array (bf16 included) as a tensor, bit for bit."""
    a = np.array(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def ints16():
    rng = np.random.default_rng(5)
    data = rng.integers(-16, 17, size=(N, D)).astype(np.float32)
    queries = rng.integers(-16, 17, size=(32, D)).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def floats():
    data = np.asarray(jax_clustered_vectors(jax.random.PRNGKey(3), N, D,
                                            n_clusters=8)) * 3.0
    rng = np.random.default_rng(7)
    queries = data[rng.choice(N, 32, replace=False)] + rng.normal(
        0, 0.05, (32, D)).astype(np.float32)
    return data, queries.astype(np.float32)


_FITS = {}


def _ref_streamed(data, bf16, tag):
    """The reference's streamed tier over S shards (PCA off), fitted with
    its bf16 toggle as given; one fit per (data, row type)."""
    if (tag, bf16) not in _FITS:
        with toggles(bf16=bf16):
            p = JaxIndexParams(pca_dim=D, **PARAMS)
            _FITS[tag, bf16] = JaxStreamed(p, n_shards=S).fit(
                jnp.asarray(data))
    return _FITS[tag, bf16]


def _blocks(ref):
    return [{k: np.array(np.asarray(v)) for k, v in
             ref.store.peek_host(i).items()} for i in range(S)]


def _local_pair(block, q, prenorm, ef=EF, max_iters=0):
    """The reference's and the port's per-shard step on one block."""
    jd, ji = jax_stream_local(
        jnp.asarray(q), *(jnp.asarray(block[f]) for f in FIELDS), ef=ef,
        k=K, max_iters=max_iters, mode="while", prenorm=prenorm)
    d, i = _local_beam(torch.from_numpy(q), *(_t(block[f]) for f in FIELDS),
                       ef=ef, k=K, max_iters=max_iters, mode="while",
                       prenorm=prenorm)
    return (_np(jd), _np(ji)), (d.numpy(), i.numpy())


def _ref_merge(blocks, q, prenorm):
    """The reference's sharded search, composed: ``_stream_local`` per
    shard, then its ``lax.top_k`` merge."""
    ds, is_ = [], []
    for b in blocks:
        d, gi = jax_stream_local(
            jnp.asarray(q), *(jnp.asarray(b[f]) for f in FIELDS), ef=EF,
            k=K, max_iters=0, mode="while", prenorm=prenorm)
        ds.append(d)
        is_.append(gi)
    nd, pos = jax.lax.top_k(-jnp.concatenate(ds, 1), K)
    return _np(-nd), _np(jnp.take_along_axis(jnp.concatenate(is_, 1), pos,
                                             axis=1))


def _mesh_index(ref, blocks, norms=True):
    """The reference's fitted tier as mesh arrays, carried onto a 2 x 4
    mesh naming the CPU eight times."""
    cat = lambda f: np.concatenate([b[f] for b in blocks])
    arrays = JaxArrays(**{f: cat(f) for f in FIELDS[:-1]},
                       pca_mean=_np(ref.pca_mean), pca_comp=_np(ref.pca_comp),
                       base_norms=cat("base_norms") if norms else None)
    like = types.SimpleNamespace(
        params=ref.params, arrays=arrays, struct_neighbors=arrays.neighbors,
        knn_ids=cat("knn_ids"), medoids=cat("medoid"), _m=ref._m,
        n_structural_builds=S)
    mesh = make_host_mesh(data=2, model=S, devices=[CPU] * (2 * S))
    return sharded_index_from_jax(like, mesh)


# -- the plain versions' lane order --------------------------------------------

def test_fma32_rounds_once():
    """fma32 gives the correctly rounded f32 of a * b + c, where a product
    rounded first would differ: (1 + 2^-12)^2 - 1 keeps its 2^-24 term."""
    a = torch.tensor([1 + 2 ** -12, 3.0, -2.5], dtype=torch.float32)
    c = torch.tensor([-1.0, 0.25, 6.25], dtype=torch.float32)
    got = fma32(a, a, c)
    assert got.tolist() == [2 ** -11 + 2 ** -24, 9.25, 12.5]
    assert float((a[0] * a[0]) + c[0]) != got[0].item()


@pytest.mark.parametrize("d", [37, 128, 600])
def test_lanes_reduce_is_the_sum_on_integers(d):
    """On integers (every partial sum exact) the lane-order reductions
    equal the plain sums, in both forms, at a ragged, a full-lane and the
    serving width."""
    g = torch.Generator().manual_seed(d)
    q = torch.randint(-16, 17, (5, d), generator=g).float()
    rows = torch.randint(-16, 17, (5, 7, d), generator=g).float()
    assert torch.equal(lanes_reduce(q, rows),
                       ((rows - q[:, None]) ** 2).sum(-1))
    assert torch.equal(lanes_reduce(q, rows, dot=True),
                       (rows * q[:, None]).sum(-1))


@pytest.mark.parametrize("bf16,prenorm", COMBOS, ids=COMBO_IDS)
def test_gather_dist_modes_on_integers(ints16, bf16, prenorm):
    """gather_dist's plain version in each mode equals the reference's
    distance of that mode (its dot form over the widened rows, or its
    prenorm gdist), +inf at ids < 0."""
    data, queries = ints16
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, N, (len(queries), 12)).astype(np.int32)
    db = torch.from_numpy(data)
    db = db.bfloat16() if bf16 else db
    norms = row_norms(torch.from_numpy(data)) if prenorm else None
    got = gather_dist(torch.from_numpy(queries), db, torch.from_numpy(ids),
                      norms=norms)
    assert torch.equal(got, gather_dist_ref(torch.from_numpy(queries), db,
                                            torch.from_numpy(ids), norms))
    rows = data[np.maximum(ids, 0)]
    want = ((rows - queries[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), np.where(ids >= 0, want,
                                                        np.inf))


# -- the per-shard step and the tiers against the reference -------------------

@pytest.mark.parametrize("bf16,prenorm", COMBOS, ids=COMBO_IDS)
def test_local_step_equals_the_reference_on_integers(ints16, bf16, prenorm):
    """Every shard's step, on the reference's fitted blocks (bf16 base when
    the toggle was on at fit), equals its ``_stream_local``: ids and
    distances exactly, with the full and the tight hop budget."""
    data, queries = ints16
    ref = _ref_streamed(data, bf16, "ints")
    blocks = _blocks(ref)
    assert blocks[0]["base"].dtype.name == ("bfloat16" if bf16 else
                                            "float32")
    for b in blocks:
        for budget in (0, 2 * EF):
            (jd, ji), (d, i) = _local_pair(b, queries, prenorm,
                                           max_iters=budget)
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_array_equal(d, jd)


@pytest.mark.parametrize("bf16,prenorm", COMBOS, ids=COMBO_IDS)
def test_tiers_equal_the_reference_on_integers(ints16, bf16, prenorm):
    """The carried streamed tier, the carried mesh tier (with and without
    base_norms: the step then derives them from the base, as the
    reference's does) and the reference's own streamed search and composed
    per-shard search: all equal, ids and distances, under the toggles."""
    data, queries = ints16
    ref = _ref_streamed(data, bf16, "ints")
    blocks = _blocks(ref)
    q = torch.from_numpy(queries)
    with toggles(bf16=bf16, prenorm=prenorm):
        streamed = streamed_sharded_index_from_jax(ref, device="cpu")
        d_s, i_s = streamed.search(q, K)
        jd, ji = ref.search(jnp.asarray(queries), K)
        mesh = _mesh_index(ref, blocks)
        d_m, i_m = mesh.search(q, K)
        d_n, i_n = _mesh_index(ref, blocks, norms=False).search(q, K)
    assert streamed.store.peek_host(0)["base"].dtype == (
        torch.bfloat16 if bf16 else torch.float32)
    assert mesh.arrays.base.dtype == streamed.store.peek_host(0)["base"].dtype
    cd, ci = _ref_merge(blocks, queries, prenorm)
    for d, i in ((d_s, i_s), (d_m, i_m), (d_n, i_n)):
        np.testing.assert_array_equal(i.numpy(), _np(ji))
        np.testing.assert_array_equal(d.numpy(), _np(jd))
    np.testing.assert_array_equal(i_s.numpy(), ci)
    np.testing.assert_array_equal(d_s.numpy(), cd)


@pytest.mark.parametrize("bf16,prenorm", COMBOS, ids=COMBO_IDS)
def test_local_step_on_float_data(floats, bf16, prenorm):
    """Float data (clustered, scaled by 3): the per-shard step's ids equal
    the reference's, its distances within FLOAT_TOL of |q|^2 + |x|^2."""
    data, queries = floats
    ref = _ref_streamed(data, bf16, "floats")
    for b in _blocks(ref):
        (jd, ji), (d, i) = _local_pair(b, queries, prenorm)
        np.testing.assert_array_equal(i, ji)
        rows = b["base"].astype(np.float32)
        scale = np.broadcast_to((queries ** 2).sum(-1)[:, None]
                                + (rows ** 2).sum(-1).max(), d.shape)
        fin = np.isfinite(jd)
        assert (np.isfinite(d) == fin).all()
        assert (np.abs(d - jd)[fin] <= FLOAT_TOL * scale[fin]).all()


def test_tiers_agree_on_their_own_fits(floats):
    """The port's own fits of both tiers, every toggle on: equal searches
    bit for bit, bf16 rows in both, norms of the f32 rows."""
    data, queries = floats
    p = IndexParams(pca_dim=D, **PARAMS)
    with toggles(bf16=True, prenorm=True, tight=True):
        a = ShardedIndex(p, make_host_mesh(data=2, model=S,
                                           devices=[CPU] * (2 * S))).fit(data)
        b = StreamedShardedIndex(p, S, device="cpu").fit(data)
        q = torch.from_numpy(queries)
        (da, ia), (db_, ib) = a.search(q, K), b.search(q, K)
    assert torch.equal(ia, ib) and torch.equal(da, db_)
    host = b.store.peek_host(0)
    assert host["base"].dtype == torch.bfloat16
    assert not torch.equal(host["base_norms"], row_norms(host["base"]))


def test_tight_budget_with_bf16_keeps_recall():
    """The counterpart of the reference's
    test_perf_opts.py::test_ann_bf16_and_tight_budget_keep_recall (whose
    shard_map does not trace here): the port's mesh tier with bf16 rows and
    the tight budget, PCA 24 of 32 dims, one shard, fori mode, keeps
    recall@10 above a floor a point under its measured 0.8813."""
    g = torch.Generator().manual_seed(0)
    data = clustered_vectors(g, 2000, 32, n_clusters=16)
    queries = queries_like(torch.Generator().manual_seed(1), data, 64)
    _, true_i = FlatIndex(data).search(queries, 10)
    p = IndexParams(pca_dim=24, antihub_keep=1.0, ep_clusters=4,
                    ef_search=48, graph_degree=12, build_knn_k=12,
                    build_candidates=32, knn_backend="exact",
                    finish_backend="host")
    with toggles(bf16=True, tight=True):
        idx = ShardedIndex(p, make_host_mesh(1, 1, devices=[CPU])).fit(data)
        assert idx.arrays.base.dtype == torch.bfloat16
        _, i = idx.search(queries, 10, mode="fori")
    r = float(recall_at_k(i, true_i))
    assert r >= 0.87, r


def test_bf16_sharded_snapshot_round_trips(ints16, tmp_path):
    """A bf16 sharded tier's blocks as one payload in the reference's
    sharded layout (``sub<i>/<field>``): written by either package's
    checkpointer, read by the other's, bit for bit (bf16 through its
    uint16 view, checksums verified)."""
    data, _ = ints16
    ref = _ref_streamed(data, True, "ints")
    port = streamed_sharded_index_from_jax(ref, device="cpu")
    ref_arrays = {f"sub{i}/{k}": np.asarray(v) for i in range(S)
                  for k, v in ref.store.peek_host(i).items()}
    port_arrays = {f"sub{i}/{k}": v for i in range(S)
                   for k, v in port.store.peek_host(i).items()}
    jax_write_payload(str(tmp_path / "ref"), ref_arrays, {"n_shards": S})
    write_payload(str(tmp_path / "port"), port_arrays, {"n_shards": S})
    got, manifest = read_payload(str(tmp_path / "ref"))
    assert manifest["dtypes"]["sub0/base"] == "bfloat16"
    assert got["sub0/base"].dtype == torch.bfloat16
    for k, v in port_arrays.items():
        assert torch.equal(torch.as_tensor(got[k]), v), k
    back, manifest2 = jax_read_payload(str(tmp_path / "port"))
    assert manifest2["checksums"] == manifest["checksums"]
    for k, v in ref_arrays.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8)
                                      if v.dtype.name == "bfloat16"
                                      else back[k],
                                      v.view(np.uint8)
                                      if v.dtype.name == "bfloat16" else v)


def test_reprune_of_a_bf16_block_keeps_its_bits(ints16):
    """derive_local widens a bf16 block to f32 rows before its α-scan (as
    the reference's does): on rows bf16 holds exactly, each shard's
    derived graph from its bf16 block equals the one from the f32 block
    and the reference's, bit for bit; and both tiers' reprunes of the
    carried bf16 tier equal each other."""
    data, queries = ints16
    blocks = _blocks(_ref_streamed(data, True, "ints"))
    for b in blocks:
        args = (_t(b["neighbors"]), _t(b["knn_ids"]), int(b["medoid"][0]),
                _t(b["global_ids"]) >= 0)
        base16 = _t(b["base"])
        got = derive_local(base16, *args, alpha=1.2, degree=8)
        assert torch.equal(got, derive_local(base16.float(), *args,
                                             alpha=1.2, degree=8))
        want = jax_derive_local(
            jnp.asarray(b["base"]), jnp.asarray(b["neighbors"]),
            jnp.asarray(b["knn_ids"]), b["medoid"][0],
            jnp.asarray(b["global_ids"]) >= 0, alpha=1.2, degree=8)
        np.testing.assert_array_equal(got.numpy(), _np(want))
    ref = _ref_streamed(data, True, "ints")
    with toggles(bf16=True):
        streamed = streamed_sharded_index_from_jax(ref, device="cpu")
        mesh = _mesh_index(ref, blocks)
        ds = streamed.reprune(alpha=1.2, degree=8)
        dm = mesh.reprune(alpha=1.2, degree=8)
        q = torch.from_numpy(queries)
        (d1, i1), (d2, i2) = ds.search(q, K), dm.search(q, K)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)


def test_hop_loop_plain_version_takes_the_modes(ints16):
    """beam_hops_ref with bf16 rows and norms equals the f32 run on the
    widened rows where the two distances agree (integer data): the modes
    change what is read and how it is summed, not what is found."""
    from repro_torch.core.beam_search import _seed_batched
    from repro_torch.core.knn_graph import knn_graph
    data, queries = ints16
    x = torch.from_numpy(data)
    _, nbrs = knn_graph(x, 8)
    entry = torch.arange(len(queries), dtype=torch.int32) * 7
    q = torch.from_numpy(queries)
    kw = dict(k=K, max_iters=48, max_steps=48)
    outs = []
    for db, norms in ((x, None), (x.bfloat16(), None), (x, row_norms(x)),
                      (x.bfloat16(), row_norms(x))):
        st = _seed_batched(q, db, nbrs, entry, 16,
                           lambda q_, db_, ids: gather_dist(q_, db_, ids,
                                                            norms=norms))
        outs.append(beam_hops_ref(nbrs, *st[:6], st[7], q, db, norms=norms,
                                  **kw))
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


# -- the compacted search's buckets -------------------------------------------

@pytest.mark.parametrize("buckets", [None, (8, 16, 48)])
def test_compacted_buckets_equal_the_reference(buckets):
    """beam_search_compacted(buckets=) dispatches the batch sizes the
    reference's does (the first bucket that holds the live lanes, from the
    given set or pow2_buckets(Q)), with the same results, on integer data
    (every distance exact in both packages' forms)."""
    rng = np.random.default_rng(0)
    data = rng.integers(-3, 4, (600, 8)).astype(np.float32)
    nbrs = np.array(jax_knn_graph(jnp.asarray(data), 10)[1])
    queries = rng.integers(-3, 4, (40, 8)).astype(np.float32)
    entry = rng.integers(0, 600, 40).astype(np.int32)
    kw = dict(ef=16, k=10, compact_every=3, buckets=buckets,
              with_stats=True)
    log, jlog = [], []
    got = beam_search_compacted(
        *(torch.from_numpy(a) for a in (queries, data, nbrs, entry)),
        shape_log=log, **kw)
    want = jax_beam_search_compacted(
        *(jnp.asarray(a) for a in (queries, data, nbrs, entry)),
        shape_log=jlog, **kw)
    assert log == jlog and log[0] == (64 if buckets is None else 48)
    for g, w in zip(got[:2] + tuple(got[2][:3]),
                    want[:2] + tuple(want[2][:3])):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        beam_search_compacted(
            *(torch.from_numpy(a) for a in (queries, data, nbrs, entry)),
            **dict(kw, buckets=(8, 16)))
