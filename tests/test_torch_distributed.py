"""The port's sharded and out-of-core tier (``core/distributed.py``,
``distributed/sharding.py``, ``launch/mesh.py``, ``build/stream.py``,
``ShardedRepruneObjective``, the launchers' ``--shards``) against the
reference's.

The reference's own ``shard_map`` programs do not trace under this JAX
(``ShardedIndex.search`` / ``.reprune`` and ``make_sharded_l2_topk``), so
its sharded results are composed here from the pieces that run: its
``ShardedIndex.fit`` (one shard: one device), ``_stream_local`` per shard
plus its merge (``lax.top_k(-d, k)`` + ``take_along_axis``), its
``derive_local`` per shard, its per-shard ``l2_topk``, and its
``StreamedShardedIndex`` and ``ShardedFactoryIndex`` whole. Fitted
reference indexes are carried across (``repro_torch.carry``): torch
cannot replay jax.random, so parity comes from carrying the fitted
arrays, not from refitting.

Tolerances: on integer data (coordinates in [-3, 3], PCA off) every
comparison is exact — ids, distances, derived graphs. With PCA on (float
data) the query projection agrees to rtol 1e-6 and the ids exactly; the
dot-formula distances, whose dot each package sums in its own order,
agree to 1e-6 of their operands' scale (|q|^2 + |x|^2).

The CPU mesh names ``torch.device("cpu")`` once per shard, as the
reference's tests use fake XLA devices; the shards run one after the
other in one process either way.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro import flags as jax_flags
from repro.core import IndexParams as JaxIndexParams
from repro.core import load_index as jax_load_index
from repro.core import save_index as jax_save_index
from repro.core.distances import l2_topk as jax_l2_topk
from repro.core.distributed import ShardedFactoryIndex as JaxShardedFactory
from repro.core.distributed import ShardedIndex as JaxShardedIndex
from repro.core.distributed import ShardedIndexArrays as JaxArrays
from repro.core.distributed import StreamedShardedIndex as JaxStreamed
from repro.core.distributed import _stream_local as jax_stream_local
from repro.core.distributed import shard_bounds as jax_shard_bounds
from repro.core.build import derive_local as jax_derive_local
from repro.core.build import HostOffloadStore as JaxStore
from repro.core.persist import index_state as jax_index_state
from repro.core.tuning import ShardedRepruneObjective as JaxShardedObjective
from repro.data import clustered_vectors as jax_clustered_vectors
from repro.launch.mesh import make_host_mesh as jax_make_host_mesh
from repro.serve.faults import FaultInjector as JaxFaultInjector
from repro_torch import flags
from repro_torch.carry import (
    index_from_jax_state, sharded_index_from_jax,
    streamed_sharded_index_from_jax,
)
from repro_torch.core.build import HostOffloadStore
from repro_torch.core.build.finish import reachable_mask
from repro_torch.core.distributed import (
    ShardedFactoryIndex, ShardedIndex, StreamedShardedIndex, _local_beam,
    device_array_bytes, make_sharded_l2_topk, shard_bounds,
)
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.persist import load_index, save_index
from repro_torch.core.pipeline import IndexParams, structural_build_count
from repro_torch.core.tuning import ShardedRepruneObjective
from repro_torch.distributed.sharding import (
    RowSharded, put_row_sharded, row_sharded_from_blocks, shard_map,
)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import tune as tune_cli
from repro_torch.launch.mesh import data_axes, make_host_mesh, model_axis
from repro_torch.serve.faults import FaultInjector

CPU = torch.device("cpu")
N, D, S, K, EF = 600, 32, 3, 10, 32
FIELDS = ("base", "neighbors", "global_ids", "centroids", "members",
          "base_norms")
PARAMS = dict(antihub_keep=1.0, ep_clusters=4, ef_search=EF,
              graph_degree=12, build_knn_k=12, build_candidates=24,
              knn_backend="exact", finish_backend="host")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(s, data=1):
    return make_host_mesh(data=data, model=s, devices=[CPU] * (s * data))


def _np(a):
    return np.asarray(a)


@pytest.fixture(scope="module")
def ints():
    rng = np.random.default_rng(11)
    data = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    queries = rng.integers(-3, 4, size=(48, D)).astype(np.float32)
    return data, queries


@pytest.fixture(scope="module")
def ref_streamed(ints):
    """The reference's streamed tier over 3 shards (PCA off): its search
    and reprune run whole in this JAX."""
    data, _ = ints
    p = JaxIndexParams(pca_dim=D, **PARAMS)
    return JaxStreamed(p, n_shards=S).fit(jnp.asarray(data))


@pytest.fixture(scope="module")
def ref_single():
    """A reference ShardedIndex fitted on a one-shard mesh (its fit runs),
    PCA on, AntiHub on: float data."""
    data = np.asarray(jax_clustered_vectors(jax.random.PRNGKey(0), 500, D,
                                            n_clusters=8))
    p = JaxIndexParams(pca_dim=24, **dict(PARAMS, antihub_keep=0.9))
    ref = JaxShardedIndex(p, jax_make_host_mesh(1, 1)).fit(jnp.asarray(data))
    rng = np.random.default_rng(2)
    queries = data[rng.choice(500, 32, replace=False)] + 0.01
    return ref, data, queries


def _ref_blocks(ref_store, s):
    return [{k: _np(v) for k, v in ref_store.peek_host(i).items()}
            for i in range(s)]


def _ref_compose_search(blocks, mean, comp, queries, k=K, ef=EF):
    """The reference's sharded search, composed from its working pieces:
    ``_stream_local`` per shard, then its merge."""
    q = (jnp.asarray(queries) - jnp.asarray(mean)) @ jnp.asarray(comp)
    ds, is_ = [], []
    for b in blocks:
        d, gi = jax_stream_local(
            q, *(jnp.asarray(b[f]) for f in FIELDS), ef=ef, k=k,
            max_iters=0, mode="while", prenorm=False)
        ds.append(d)
        is_.append(gi)
    d, i = jnp.concatenate(ds, 1), jnp.concatenate(is_, 1)
    nd, pos = jax.lax.top_k(-d, k)
    return _np(-nd), _np(jnp.take_along_axis(i, pos, axis=1))


def _ref_like_sharded(ref_streamed):
    """The mesh arrays the reference's ShardedIndex.fit assembles, from
    its streamed tier's blocks (AntiHub off: both pad to ceil(N/S))."""
    blocks = _ref_blocks(ref_streamed.store, S)
    cat = lambda f: np.concatenate([b[f] for b in blocks])
    arrays = JaxArrays(**{f: cat(f) for f in FIELDS},
                       pca_mean=_np(ref_streamed.pca_mean),
                       pca_comp=_np(ref_streamed.pca_comp))
    return types.SimpleNamespace(
        params=ref_streamed.params, arrays=arrays,
        struct_neighbors=arrays.neighbors, knn_ids=cat("knn_ids"),
        medoids=cat("medoid"), _m=ref_streamed._m,
        n_structural_builds=S), blocks


# -- mesh and placement -------------------------------------------------------

def test_mesh_shapes_and_axes():
    m = make_host_mesh(data=2, model=4, devices=["cpu"] * 8)
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert data_axes(m) == ("data",) and model_axis(m) == "model"
    p = make_host_mesh(data=2, model=2, pod=2, devices=["cpu"] * 8)
    assert p.axis_names == ("pod", "data", "model")
    assert data_axes(p) == ("pod", "data")
    with pytest.raises(ValueError, match="only 3 given"):
        make_host_mesh(model=4, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh(model=2)


def test_row_sharded_placement_and_shard_map():
    mesh = _mesh(3, data=2)
    x = torch.arange(24, dtype=torch.float32).reshape(12, 2)
    rs = put_row_sharded(mesh, x)
    assert rs.shape == (12, 2) and rs.nbytes == x.numel() * 4
    np.testing.assert_array_equal(np.asarray(rs), x.numpy())
    same = row_sharded_from_blocks(mesh, list(x.split(4)))
    np.testing.assert_array_equal(same.to_host().numpy(), x.numpy())
    with pytest.raises(ValueError, match="equal-shape"):
        row_sharded_from_blocks(mesh, [x[:4], x[:4], x[:3]])
    with pytest.raises(ValueError, match="2 blocks for 3"):
        RowSharded(mesh, [x[:4], x[:4]])
    doubled = shard_map(lambda b: b * 2, mesh, rs)
    np.testing.assert_array_equal(doubled.to_host().numpy(), 2 * x.numpy())
    q = torch.arange(8, dtype=torch.float32)[:, None]
    (out,) = shard_map(lambda qq, b: (qq + b[:, 0].sum(),), mesh, rs,
                       batch=q, out="batch")
    sums = x[:, 0].reshape(3, 4).sum(1)
    np.testing.assert_array_equal(out.numpy(),
                                  (q + sums[None, :]).numpy())
    with pytest.raises(ValueError, match="batch groups"):
        shard_map(lambda qq, b: (qq,), mesh, rs, batch=q[:3], out="batch")


@pytest.mark.parametrize("n,s", [(10, 3), (7, 4), (2000, 3), (1000003, 7),
                                 (5, 5), (16, 1), (999999, 8)])
def test_shard_bounds_equal_the_reference(n, s):
    b = shard_bounds(n, s)
    np.testing.assert_array_equal(b, jax_shard_bounds(n, s))
    sizes = np.diff(b)
    assert sizes.sum() == n and sizes.max() - sizes.min() <= 1
    assert sizes.max() == -(-n // s)


def test_host_offload_store_roundtrip():
    tree = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
            "b": np.ones((5,), np.float32)}
    store, jstore = HostOffloadStore(device="cpu"), JaxStore()
    store.offload(0, {k: torch.from_numpy(v) for k, v in tree.items()})
    jstore.offload(0, {k: jnp.asarray(v) for k, v in tree.items()})
    assert 0 in store and list(store.keys()) == [0]
    assert store.nbytes() == jstore.nbytes() == 12 * 4 + 5 * 4
    host = store.peek_host(0)
    store.prefetch(0)
    out = store.fetch(0)
    for k, v in tree.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
        assert out[k] is host[k]        # the CPU store stages in place
    out2 = store.fetch(0)               # un-prefetched fetch works too
    np.testing.assert_array_equal(out2["a"].numpy(), tree["a"])
    store.offload(1, dict(host, b=torch.zeros(5)))
    assert store.peek_host(1)["a"] is host["a"]     # shared, not copied
    store.drop(0)
    store.drop(1)
    assert 0 not in store and store.nbytes() == 0


# -- the sharded graph index, carried from the reference ---------------------

def test_carried_single_shard_index_matches_the_reference(ref_single):
    """A reference ShardedIndex (its own fit, PCA and AntiHub on) carried
    onto a one-shard CPU mesh. On this float data the query projection
    agrees to rtol 1e-6, the ids exactly, and the distances to 1e-6 of
    the dot-formula's operands (|q|^2 + |x|^2, the scale its cancellation
    error is relative to: each package sums the dot in its own order)."""
    ref, data, queries = ref_single
    idx = sharded_index_from_jax(ref, _mesh(1))
    a = ref.arrays
    blocks = [{f: _np(getattr(a, f)) for f in FIELDS}]
    q = torch.from_numpy(queries)
    proj = (q - idx.arrays.pca_mean) @ idx.arrays.pca_comp
    jproj = (jnp.asarray(queries) - a.pca_mean) @ a.pca_comp
    np.testing.assert_allclose(proj.numpy(), _np(jproj), rtol=1e-6,
                               atol=1e-6)
    want_d, want_i = _ref_compose_search(blocks, _np(a.pca_mean),
                                         _np(a.pca_comp), queries)
    d, i = idx.search(q, K)
    np.testing.assert_array_equal(i.numpy(), want_i)
    scale = float((proj ** 2).sum(1).max()
                  + (idx.arrays.base.blocks[0] ** 2).sum(1).max())
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=1e-6 * scale)
    assert idx.ntotal == int((_np(a.global_ids) >= 0).sum())
    assert idx.n_shards == 1 and idx.dim == D
    assert idx.memory_bytes() >= (int(_np(a.base).nbytes)
                                  + int(_np(a.neighbors).nbytes))


def test_carried_sharded_index_search_is_exact(ref_streamed, ints):
    data, queries = ints
    ref_like, blocks = _ref_like_sharded(ref_streamed)
    idx = sharded_index_from_jax(ref_like, _mesh(S))
    want_d, want_i = _ref_compose_search(
        blocks, _np(ref_streamed.pca_mean), _np(ref_streamed.pca_comp),
        queries)
    d, i = idx.search(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(d.numpy(), want_d)
    # and the reference's whole streamed search, the same merge
    jd, ji = ref_streamed.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    # a data axis of 2 splits the batch and gives the same answers
    idx2 = sharded_index_from_jax(ref_like, _mesh(S, data=2))
    d2, i2 = idx2.search(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(i2.numpy(), want_i)
    np.testing.assert_array_equal(d2.numpy(), want_d)


@pytest.mark.parametrize("alpha,degree", [(1.2, 8), (1.0, 12), (1.4, 5)])
def test_carried_sharded_reprune_is_exact(ref_streamed, ints, alpha,
                                          degree):
    """ShardedIndex.reprune == the reference's derive_local applied per
    shard to its fitted arrays; no rebuild; the parent keeps serving."""
    _, queries = ints
    ref_like, blocks = _ref_like_sharded(ref_streamed)
    idx = sharded_index_from_jax(ref_like, _mesh(S))
    before = structural_build_count()
    der = idx.reprune(alpha=alpha, degree=degree)
    assert structural_build_count() == before
    assert der.n_structural_builds == idx.n_structural_builds == S
    assert der.params.graph_degree == degree and der.params.alpha == alpha
    for s, b in enumerate(blocks):
        want = jax_derive_local(
            jnp.asarray(b["base"]), jnp.asarray(b["neighbors"]),
            jnp.asarray(b["knn_ids"]), b["medoid"][0],
            jnp.asarray(b["global_ids"]) >= 0, alpha=alpha, degree=degree)
        got = der.arrays.neighbors.blocks[s]
        np.testing.assert_array_equal(got.numpy(), _np(want))
        valid = torch.from_numpy(b["global_ids"] >= 0)
        assert bool((reachable_mask(got, int(b["medoid"][0])) | ~valid)
                    .all())
    for f in ("base", "global_ids", "centroids", "members", "base_norms"):
        assert getattr(der.arrays, f) is getattr(idx.arrays, f)
    assert der.memory_bytes() == idx.memory_bytes() + \
        der.arrays.neighbors.nbytes
    derived_blocks = [dict(b, neighbors=der.arrays.neighbors.blocks[s]
                           .numpy()) for s, b in enumerate(blocks)]
    want_d, want_i = _ref_compose_search(
        derived_blocks, _np(ref_streamed.pca_mean),
        _np(ref_streamed.pca_comp), queries)
    d, i = der.search(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(i.numpy(), want_i)
    np.testing.assert_array_equal(d.numpy(), want_d)


def test_carried_streamed_index_matches_the_reference(ref_streamed, ints):
    """StreamedShardedIndex carried from the reference's store: search,
    reprune (shard by shard), the shared host buffers and memory_bytes all
    equal the reference's."""
    _, queries = ints
    idx = streamed_sharded_index_from_jax(ref_streamed, device="cpu")
    assert idx.ntotal == ref_streamed.ntotal == N
    assert idx.memory_bytes() == ref_streamed.memory_bytes()
    d, i = idx.search(torch.from_numpy(queries), K)
    jd, ji = ref_streamed.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    before = structural_build_count()
    der = idx.reprune(alpha=1.2, degree=8)
    jder = ref_streamed.reprune(alpha=1.2, degree=8)
    assert structural_build_count() == before
    for key in idx.store.keys():
        parent, child = idx.store.peek_host(key), der.store.peek_host(key)
        np.testing.assert_array_equal(
            child["neighbors"].numpy(),
            _np(jder.store.peek_host(key)["neighbors"]))
        for field in ("base", "global_ids", "centroids", "members",
                      "base_norms", "knn_ids", "medoid"):
            assert child[field] is parent[field], f"{field} not shared"
    der_nbytes = sum(der.store.peek_host(k)["neighbors"].numel() * 4
                     for k in der.store.keys())
    assert der.memory_bytes() == idx.memory_bytes() + der_nbytes
    assert der.memory_bytes() == jder.memory_bytes()
    d2, i2 = der.search(torch.from_numpy(queries), K)
    jd2, ji2 = jder.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i2.numpy(), _np(ji2))
    np.testing.assert_array_equal(d2.numpy(), _np(jd2))


def test_tight_budget_is_honoured(ref_streamed, ints, monkeypatch):
    """ANN_TIGHT_BUDGET (2 * ef hops) in both packages: equal results,
    and the same as an explicit max_iters = 2 * ef."""
    _, queries = ints
    monkeypatch.setattr(flags, "ANN_TIGHT_BUDGET", True)
    monkeypatch.setattr(jax_flags, "ANN_TIGHT_BUDGET", True)
    idx = streamed_sharded_index_from_jax(ref_streamed, device="cpu")
    d, i = idx.search(torch.from_numpy(queries), K, ef=12)
    jd, ji = ref_streamed.search(jnp.asarray(queries), K, ef=12)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    ref_like, blocks = _ref_like_sharded(ref_streamed)
    mesh_idx = sharded_index_from_jax(ref_like, _mesh(S))
    d2, i2 = mesh_idx.search(torch.from_numpy(queries), K, ef=12)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())


@pytest.mark.parametrize("toggle", ["ANN_BF16_BASE", "ANN_PRENORM"])
def test_unported_toggles_raise(ints, monkeypatch, capsys, toggle):
    """The bf16-row and prenorm toggles, which the sharded entry points
    refused before the hop loop had those modes, now serve: with either
    on, the port's two tiers fit the integer data (which bf16 holds
    exactly) and search it bit for bit alike, the base is stored in the
    toggle's type, and the tune CLI's --shards runs
    (tests/test_torch_ann_toggles.py holds them to the reference)."""
    data, queries = ints
    monkeypatch.setattr(flags, toggle, True)
    p = IndexParams(pca_dim=D, **PARAMS)
    streamed = StreamedShardedIndex(p, 2, device="cpu").fit(data)
    mesh = ShardedIndex(p, _mesh(2)).fit(data)
    want = torch.bfloat16 if toggle == "ANN_BF16_BASE" else torch.float32
    assert streamed.store.peek_host(0)["base"].dtype == want
    assert mesh.arrays.base.dtype == want
    q = torch.from_numpy(queries)
    ds, is_ = streamed.search(q, K)
    dm, im = mesh.search(q, K)
    assert torch.equal(is_, im) and torch.equal(ds, dm)
    tune_cli.main(["--device", "cpu", "--n", "200", "--dim", "8",
                   "--queries", "8", "--trials", "1", "--shards", "2"])
    assert "(OK — one per shard)" in capsys.readouterr().out


# -- the port's own fits: the two tiers agree --------------------------------

def test_sharded_and_streamed_fits_agree():
    """The port's ShardedIndex (a 3-device CPU mesh) and
    StreamedShardedIndex fit every shard from the same derived generator:
    equal graphs, so equal searches and reprunes, although the mesh pads
    its shards to max(kept rows) and the streamed tier to ceil(N / S)."""
    g = torch.Generator().manual_seed(0)
    from repro_torch.data import clustered_vectors, queries_like
    data = clustered_vectors(g, 900, D, n_clusters=12)
    queries = queries_like(torch.Generator().manual_seed(1), data, 48)
    _, true_i = FlatIndex(data).search(queries, K)
    p = IndexParams(pca_dim=24, **dict(PARAMS, antihub_keep=0.9))
    b0 = structural_build_count()
    a = ShardedIndex(p, _mesh(S)).fit(data)
    b = StreamedShardedIndex(p, S, device="cpu").fit(data)
    assert structural_build_count() - b0 == 2 * S
    assert a._m == 270 and b._m == 300          # different padding
    assert a.ntotal == b.ntotal == 810
    da, ia = a.search(queries, K)
    db, ib = b.search(queries, K)
    assert torch.equal(ia, ib) and torch.equal(da, db)
    # recall floor pinned a point under the measured 0.875
    assert recall_at_k(ia, true_i) >= 0.86
    ra, rb = a.reprune(alpha=1.2, degree=8), b.reprune(alpha=1.2, degree=8)
    assert structural_build_count() - b0 == 2 * S
    da, ia = ra.search(queries, K)
    db, ib = rb.search(queries, K)
    assert torch.equal(ia, ib) and torch.equal(da, db)
    assert recall_at_k(ia, true_i) >= 0.85      # measured 0.865
    assert len(a.shard_stats) == len(b.shard_stats) == S
    assert all(st["n"] == 270 for st in a.shard_stats)


def test_sharded_l2_topk_matches_the_reference(ints):
    """make_sharded_l2_topk over 4 CPU shards == the reference's per-shard
    l2_topk plus its merge, exactly (ties included: integer data)."""
    data, queries = ints
    fn = make_sharded_l2_topk(_mesh(4), k=K, chunk=64)
    m = N // 4
    offs = np.arange(4, dtype=np.int32) * m
    d, i = fn(torch.from_numpy(queries), torch.from_numpy(data), offs)
    ds, is_ = [], []
    for s in range(4):
        jd, ji = jax_l2_topk(jnp.asarray(queries),
                             jnp.asarray(data[s * m:(s + 1) * m]), K,
                             chunk=64)
        ds.append(jd)
        is_.append(jnp.where(ji >= 0, ji + int(offs[s]), -1))
    nd, pos = jax.lax.top_k(-jnp.concatenate(ds, 1), K)
    want_i = jnp.take_along_axis(jnp.concatenate(is_, 1), pos, axis=1)
    np.testing.assert_array_equal(i.numpy(), _np(want_i))
    np.testing.assert_array_equal(d.numpy(), _np(-nd))
    _, flat_i = FlatIndex(torch.from_numpy(data)).search(
        torch.from_numpy(queries), K)
    assert torch.equal(i, flat_i)


def test_padded_entry_point_slots_masked():
    """A padded (all-zero) centroid slot never wins the entry argmin: row 0
    is edge-less, so entering there would strand the beam. The port's and
    the reference's local step agree, with the prenorm distance too."""
    base = np.array([[100.0, 100.0], [5.0, 5.0], [5.5, 5.0], [5.0, 5.5]],
                    np.float32)
    nbrs = np.array([[-1, -1], [2, 3], [1, 3], [1, 2]], np.int32)
    gids = np.arange(4, dtype=np.int32)
    cents = np.array([[5.2, 5.2], [0.0, 0.0]], np.float32)
    members = np.array([1, -1], np.int32)
    q = np.zeros((1, 2), np.float32)
    args = [torch.from_numpy(a) for a in (q, base, nbrs, gids, cents,
                                          members)]
    d, gi = _local_beam(*args, ef=4, k=3, max_iters=16, mode="while")
    jd, jgi = jax_stream_local(*(jnp.asarray(a) for a in (
        q, base, nbrs, gids, cents, members)), None, ef=4, k=3,
        max_iters=16, mode="while", prenorm=False)
    assert set(gi[0].tolist()) == {1, 2, 3}
    np.testing.assert_array_equal(gi.numpy(), _np(jgi))
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    norms = (base * base).sum(-1)
    d, gi = _local_beam(*args, torch.from_numpy(norms), ef=4, k=3,
                        max_iters=16, mode="while", prenorm=True)
    jd, jgi = jax_stream_local(*(jnp.asarray(a) for a in (
        q, base, nbrs, gids, cents, members, norms)), ef=4, k=3,
        max_iters=16, mode="while", prenorm=True)
    assert set(gi[0].tolist()) == {1, 2, 3}
    np.testing.assert_array_equal(gi.numpy(), _np(jgi))
    np.testing.assert_array_equal(d.numpy(), _np(jd))


# -- the factory wrapper -----------------------------------------------------

@pytest.fixture(scope="module")
def ref_factory(ints):
    data, _ = ints
    return JaxShardedFactory("NSG12,EP4", n_shards=2, knn_backend="exact",
                             finish_backend="host").fit(
        jnp.asarray(data), key=jax.random.PRNGKey(0))


def test_carried_factory_index_search_and_reprune(ref_factory, ints):
    data, queries = ints
    idx = index_from_jax_state(jax_index_state(ref_factory), device="cpu")
    assert isinstance(idx, ShardedFactoryIndex)
    assert idx.ntotal == ref_factory.ntotal == N and idx.dim == D
    d, i = idx.search(torch.from_numpy(queries), K)
    jd, ji = ref_factory.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    der = idx.reprune(alpha=1.2, degree=8)
    jder = ref_factory.reprune(alpha=1.2, degree=8)
    for sub, jsub in zip(der.subs, jder.subs):
        np.testing.assert_array_equal(sub.graph.neighbors.numpy(),
                                      _np(jsub.graph.neighbors))
    # chained reprunes derive from the structural shards, never compound
    again = der.reprune(alpha=1.0, degree=12)
    for sub, ssub in zip(again.subs, idx.subs):
        assert sub.graph.neighbors.shape[1] == 12
        assert ssub.base is sub.base
    d2, i2 = der.search(torch.from_numpy(queries), K)
    jd2, ji2 = jder.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i2.numpy(), _np(ji2))
    assert idx.memory_bytes() == sum(s.memory_bytes() for s in idx.subs)
    assert idx.search_params_space().names() == \
        ref_factory.search_params_space().names()


def test_sharded_objective_sweep_single_build(ref_factory, ints):
    """ShardedRepruneObjective: one fixed trial list gives the reference's
    cache behaviour and recalls on the carried index; a fresh port fit is
    one structural build per shard and the sweep adds none."""
    data, queries = ints
    idx = index_from_jax_state(jax_index_state(ref_factory), device="cpu")
    trials = [{"graph_degree": 12, "alpha": 1.0, "ef_search": 48},
              {"graph_degree": 8, "alpha": 1.0, "ef_search": 48},
              {"graph_degree": 12, "alpha": 1.2, "ef_search": 64},
              {"graph_degree": 8, "alpha": 1.01, "ef_search": 96}]
    obj = ShardedRepruneObjective(idx, data, queries, k=K, qps_repeats=1)
    jobj = JaxShardedObjective(ref_factory, jnp.asarray(data),
                               jnp.asarray(queries), k=K, qps_repeats=1)
    res = [obj.evaluate(t) for t in trials]
    jres = [jobj.evaluate(t) for t in trials]
    assert (obj.reprunes, obj.grid_hits) == (jobj.reprunes,
                                             jobj.grid_hits) == (2, 1)
    # equal hit sets; the float mean of each is rounded in its own order
    assert [r.recall for r in res] == pytest.approx(
        [r.recall for r in jres], rel=1e-6)
    assert [p for p, _ in obj.eval_log] == [p for p, _ in jobj.eval_log]
    assert all(r.qps > 0 and r.repruned for r in res)
    assert obj.space.names() == jobj.space.names()
    b0 = structural_build_count()
    own = ShardedFactoryIndex("NSG12,EP4", n_shards=2, knn_backend="exact",
                              finish_backend="host", device="cpu").fit(data)
    assert structural_build_count() - b0 == 2 == own.n_structural_builds
    obj2 = ShardedRepruneObjective(own, data, queries, k=K, qps_repeats=1)
    r2 = [obj2.evaluate(t) for t in trials]
    assert structural_build_count() - b0 == 2
    assert r2[0].recall >= 0.85              # the structural maximum
    with pytest.raises(TypeError, match="reprune"):
        ShardedRepruneObjective(FlatIndex(torch.from_numpy(data)), data,
                                queries)


def test_factory_reprune_rejects_non_graph(ints):
    data, _ = ints
    idx = ShardedFactoryIndex("Flat", n_shards=2, device="cpu").fit(data)
    with pytest.raises(TypeError, match="reprune"):
        idx.reprune(alpha=1.2)
    with pytest.raises(ValueError, match="on_shard_error"):
        ShardedFactoryIndex("Flat", on_shard_error="ignore", device="cpu")


def test_factory_memory_bytes_fallback(ints):
    data, _ = ints
    idx = ShardedFactoryIndex("Flat", n_shards=2, device="cpu").fit(data)

    class Bare:        # an Index-protocol sub with no memory_bytes
        def __init__(self, b):
            self.base = torch.from_numpy(b)

    idx.subs = [Bare(data[:300]), Bare(data[300:])]
    expect = sum(device_array_bytes(s) for s in idx.subs)
    assert expect == data.nbytes and idx.memory_bytes() == expect


def test_degraded_search_skips_a_dead_shard(ints):
    """on_shard_error="skip" with shard 0 permanently dead: the exact top-k
    over shards 1-2's rows, equal to the reference's degraded search; the
    failure is counted; with every shard dead the search raises."""
    data, queries = ints
    idx = ShardedFactoryIndex("Flat", n_shards=S, on_shard_error="skip",
                              device="cpu").fit(data)
    jidx = JaxShardedFactory("Flat", n_shards=S, on_shard_error="skip").fit(
        jnp.asarray(data))
    idx.subs[0] = FaultInjector(permanent_rate=1.0).wrap_index(idx.subs[0])
    jidx.subs[0] = JaxFaultInjector(permanent_rate=1.0).wrap_index(
        jidx.subs[0])
    d, i = idx.search(torch.from_numpy(queries), K)
    jd, ji = jidx.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_array_equal(d.numpy(), _np(jd))
    assert idx.degraded_shards == 1 and idx.last_shard_errors[0][0] == 0
    fd, fi = FlatIndex(torch.from_numpy(data[200:])).search(
        torch.from_numpy(queries), K)
    assert torch.equal(i, fi + 200) and torch.equal(d, fd)
    with pytest.raises(RuntimeError):                   # raise mode
        idx.search(torch.from_numpy(queries), K, on_shard_error="raise")
    for s in range(1, S):
        idx.subs[s] = FaultInjector(permanent_rate=1.0).wrap_index(
            idx.subs[s])
    with pytest.raises(RuntimeError, match="all 3 shards failed"):
        idx.search(torch.from_numpy(queries), K)


@pytest.mark.parametrize("spec", ["NSG12,EP4", "PCA16,Flat"])
def test_sharded_snapshots_load_in_both_packages(ref_factory, ints, spec,
                                                 tmp_path):
    """A reference sharded snapshot loads in the port and the port's in
    the reference (the ``sub<i>/`` layout): equal searches; exact on
    integer data, rtol 1e-6 through the PCA prefix."""
    data, queries = ints
    if spec == "NSG12,EP4":
        jidx = ref_factory
    else:
        jidx = JaxShardedFactory(spec, n_shards=2).fit(jnp.asarray(data))
    jd, ji = jidx.search(jnp.asarray(queries), K)
    jax_save_index(jidx, str(tmp_path / "ref"))
    idx = load_index(str(tmp_path / "ref"), device="cpu")
    assert isinstance(idx, ShardedFactoryIndex) and idx.spec == spec
    d, i = idx.search(torch.from_numpy(queries), K)
    np.testing.assert_array_equal(i.numpy(), _np(ji))
    np.testing.assert_allclose(d.numpy(), _np(jd), rtol=1e-6, atol=1e-6)
    save_index(idx, str(tmp_path / "port"))
    back = jax_load_index(str(tmp_path / "port"))
    bd, bi = back.search(jnp.asarray(queries), K)
    np.testing.assert_array_equal(_np(bi), _np(ji))
    np.testing.assert_array_equal(_np(bd), _np(jd))


# -- the launchers ------------------------------------------------------------

_TINY = ["--device", "cpu", "--n", "600", "--dim", "16", "--queries", "32",
         "--trials", "4", "--max-degree", "8", "--knn-backend", "exact",
         "--finish-backend", "host", "--mode", "single"]


def test_tune_cli_shards_streamed_pipeline(capsys, tmp_path):
    """--shards without --spec on one device: the streamed tier, one
    structural build per shard, and the bench point merged."""
    bench = tmp_path / "bench.json"
    tune_cli.main(_TINY + ["--shards", "3", "--bench-build-out",
                           str(bench)])
    out = capsys.readouterr().out
    assert "sharded build (streamed): 3 shards" in out
    assert "3 structural builds for 3 shards (OK — one per shard)" in out
    assert "-- build log (4 evals) --" in out
    doc = json.loads(bench.read_text())
    assert doc["backend"] == "cpu" and len(doc["points"]) == 1
    pt = doc["points"][0]
    assert (pt["stage"], pt["n"], pt["shards"], pt["path"]) == \
        ("sharded_build", 600, 3, "streamed")
    # a re-run replaces its own row; another key adds one
    tune_cli.merge_bench_point(str(bench), dict(pt, seconds=-1.0))
    tune_cli.merge_bench_point(str(bench), dict(pt, shards=4))
    points = json.loads(bench.read_text())["points"]
    got = [(p["shards"], p["seconds"]) for p in points]
    assert got == [(3, -1.0), (4, pt["seconds"])]


def test_tune_cli_shards_with_spec(capsys):
    tune_cli.main(_TINY + ["--spec", "NSG8", "--shards", "2"])
    out = capsys.readouterr().out
    assert "2 structural builds for 2 shards (OK — one per shard)" in out
    assert "reprune grid:" in out
    with pytest.raises(TypeError, match="reprune"):
        tune_cli.main(_TINY + ["--spec", "IVF8,Flat", "--shards", "2"])


def test_serve_cli_shards_skip_and_restore(capsys, tmp_path):
    snap = str(tmp_path / "snap")
    serve_cli.main(["--arch", "ann-laion", "--device", "cpu", "--spec",
                    "NSG8,EP4", "--shards", "2", "--on-shard-error", "skip",
                    "--snapshot", snap])
    out = capsys.readouterr().out
    assert "ann-laion [NSG8,EP4] bucketed" in out
    assert "degraded:" not in out and "resilience:" not in out
    serve_cli.main(["--arch", "ann-laion", "--device", "cpu", "--restore",
                    snap, "--on-shard-error", "skip"])
    out2 = capsys.readouterr().out
    assert out2.startswith("restored [NSG8,EP4] from")
    r1 = float(out.split("recall@10=")[1].split(",")[0])
    r2 = float(out2.split("recall@10=")[1].split(",")[0])
    assert r1 == r2 >= 0.9
