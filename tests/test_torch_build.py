"""Each build stage of the port against the reference's.

Integer-valued inputs make every distance exact in either package, so
l2_topk, knn_graph, antihub, alpha_prune, the host finishing pass and a
whole build_nsg (search pools + host finish, no PCA) must match exactly,
ties included. PCA and k-means run on float data: PCA projections agree up
to a per-column sign, k-means (started from the reference's init) within
a tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core import antihub as jax_antihub
from repro.core.build.finish import finish_nsg as jax_finish_nsg
from repro.core.build.prune import alpha_prune as jax_alpha_prune
from repro.core.build.prune import prune_in_chunks as jax_prune_in_chunks
from repro.core.distances import l2_topk as jax_l2_topk
from repro.core.kmeans import _kmeanspp_init, kmeans as jax_kmeans
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro.core.nsg import build_nsg as jax_build_nsg
from repro.core.pca import fit_pca as jax_fit_pca
from repro_torch.core import antihub
from repro_torch.core.build.finish import finish_nsg, reachable_from
from repro_torch.core.build.prune import alpha_prune, prune_in_chunks
from repro_torch.core.distances import l2_topk
from repro_torch.core.kmeans import kmeans
from repro_torch.core.knn_graph import knn_graph
from repro_torch.core.nsg import build_nsg
from repro_torch.core.pca import fit_pca


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, shape, lo=-3, hi=3):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture(scope="module")
def int_data():
    """Symmetric integer data (x and -x both present): the mean is exactly
    0, so the medoid is exact in both packages; small coordinates make
    many tied distances and some duplicate points."""
    half = _ints(np.random.default_rng(0), (300, 8))
    return np.concatenate([half, -half])


@pytest.fixture(scope="module")
def int_knn(int_data):
    d, i = jax_knn_graph(jnp.asarray(int_data), 12, query_chunk=128,
                         db_chunk=256)
    return np.array(d), np.array(i)


def test_l2_topk_exact_with_ties(int_data):
    q = _ints(np.random.default_rng(1), (37, 8))
    jd, ji = jax_l2_topk(jnp.asarray(q), jnp.asarray(int_data), 15,
                         chunk=64)
    pd, pi = l2_topk(torch.from_numpy(q), torch.from_numpy(int_data), 15,
                     chunk=64)
    _eq(pi, ji)
    _eq(pd, jd)


def test_knn_graph_exact_with_ties(int_data, int_knn):
    pd, pi = knn_graph(torch.from_numpy(int_data), 12, query_chunk=128,
                       db_chunk=256)
    _eq(pi, int_knn[1])
    _eq(pd, int_knn[0])


def test_antihub_keep_indices_exact(int_data, int_knn):
    want = jax_antihub.antihub_keep_indices(
        jnp.asarray(int_data), 0.9, k=10, knn_ids=jnp.asarray(int_knn[1]))
    got = antihub.antihub_keep_indices(
        torch.from_numpy(int_data), 0.9, k=10,
        knn_ids=torch.from_numpy(int_knn[1]))
    _eq(got, want)


def test_fit_pca_projections_up_to_sign():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((800, 16)) * 0.8 ** np.arange(16)
         ).astype(np.float32)
    pj = np.asarray(jax_fit_pca(jnp.asarray(x), 6).transform(jnp.asarray(x)))
    pt = fit_pca(torch.from_numpy(x), 6).transform(torch.from_numpy(x))
    pt = pt.numpy()
    sign = np.sign((pj * pt).sum(0))
    np.testing.assert_allclose(pt * sign, pj, rtol=1e-4, atol=1e-4)


def test_kmeans_from_the_reference_init(ann_data):
    x = np.array(ann_data["data"])
    key = jax.random.PRNGKey(3)
    init = np.array(_kmeanspp_init(key, jnp.asarray(x), 8))
    want = jax_kmeans(key, jnp.asarray(x), 8, iters=10)
    got = kmeans(None, torch.from_numpy(x), 8, iters=10,
                 init_centroids=torch.from_numpy(init))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-4,
                               atol=1e-4)
    agree = (got.assignments.numpy() == np.asarray(want.assignments))
    assert agree.mean() >= 0.99


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_alpha_prune_exact(int_data, int_knn, alpha):
    n = int_data.shape[0]
    node_ids = np.arange(n, dtype=np.int32)
    cd, ci = int_knn                    # kNN lists: ascending pools
    want = jax_alpha_prune(jnp.asarray(int_data), jnp.asarray(node_ids[:100]),
                           jnp.asarray(ci[:100]), jnp.asarray(cd[:100]), 6,
                           alpha)
    got = alpha_prune(torch.from_numpy(int_data),
                      torch.from_numpy(node_ids[:100]),
                      torch.from_numpy(ci[:100]), torch.from_numpy(cd[:100]),
                      6, alpha)
    _eq(got, want)
    want = jax_prune_in_chunks(jnp.asarray(int_data), jnp.asarray(node_ids),
                               jnp.asarray(ci), jnp.asarray(cd), 6, 256,
                               alpha)
    got = prune_in_chunks(torch.from_numpy(int_data),
                          torch.from_numpy(node_ids), torch.from_numpy(ci),
                          torch.from_numpy(cd), 6, 256, alpha)
    _eq(got, want)


def test_host_finish_exact_with_repair():
    """Two far-apart integer clusters: pruning leaves the far one
    unreachable from the medoid, so the repair loop attaches it (through
    the fallback scan, then chaining through kNN parents)."""
    rng = np.random.default_rng(4)
    a = _ints(rng, (150, 6))
    b = _ints(rng, (150, 6)) + 40.0
    data = np.concatenate([a, b])
    kd, ki = (np.array(t) for t in jax_knn_graph(jnp.asarray(data), 8))
    node_ids = np.arange(data.shape[0], dtype=np.int32)
    pruned = np.array(jax_prune_in_chunks(
        jnp.asarray(data), jnp.asarray(node_ids), jnp.asarray(ki),
        jnp.asarray(kd), 5, 128, 1.0))
    medoid = 3
    want, wstats = jax_finish_nsg(jnp.asarray(data), jnp.asarray(pruned),
                                  medoid, jnp.asarray(ki), degree=5,
                                  chunk=128, backend="host")
    got, gstats = finish_nsg(torch.from_numpy(data),
                             torch.from_numpy(pruned), medoid,
                             torch.from_numpy(ki), degree=5, chunk=128,
                             backend="host")
    _eq(got, want)
    assert gstats.repair_rounds == wstats.repair_rounds >= 1
    assert (gstats.union_width, gstats.union_dist_evals) == \
        (wstats.union_width, wstats.union_dist_evals)
    assert reachable_from(got.numpy(), medoid).all()


def test_build_nsg_identical_to_reference(int_data, int_knn):
    """Search pools + host finish, no PCA: the same neighbor table."""
    kw = dict(degree=8, n_candidates=16, chunk=128, alpha=1.0,
              pools_backend="search", finish_backend="host", with_stats=True)
    ji = int_knn[1]
    want, wstats = jax_build_nsg(jnp.asarray(int_data), jnp.asarray(ji),
                                 **kw)
    got, gstats = build_nsg(torch.from_numpy(int_data),
                            torch.from_numpy(ji), **kw)
    assert int(got.medoid) == int(want.medoid)
    _eq(got.neighbors, want.neighbors)
    assert gstats.pool_evals == wstats.pool_evals
    assert gstats.prune_evals == wstats.prune_evals
    nb = got.neighbors.numpy()
    assert reachable_from(nb, int(got.medoid)).all()
    assert ((nb >= 0).sum(1) <= 8).all()


def test_unported_build_options_raise(int_data, int_knn):
    """The options that raised before the NN-Descent and device-finish
    slices now run: table pools with the host finish, search pools with
    the device finish (both equal to the reference's graph), and the
    NN-Descent kNN backend."""
    data, ids = torch.from_numpy(int_data), torch.from_numpy(int_knn[1])
    for pools, finish in (("nndescent", "host"), ("search", "auto")):
        kw = dict(degree=8, n_candidates=16, chunk=128,
                  pools_backend=pools, finish_backend=finish,
                  with_stats=True)
        want, wstats = jax_build_nsg(jnp.asarray(int_data),
                                     jnp.asarray(int_knn[1]),
                                     merge_backend="jnp", **kw)
        got, gstats = build_nsg(data, ids, **kw)
        _eq(got.neighbors, want.neighbors)
        assert gstats.pools_backend == wstats.pools_backend == pools
        assert gstats.finish_backend == wstats.finish_backend
        assert (gstats.pool_evals, gstats.prune_evals) == \
            (wstats.pool_evals, wstats.prune_evals)
    from repro_torch.core.build import build_knn
    d, i, stats = build_knn(data, 8, backend="nndescent", with_stats=True)
    assert d.shape == i.shape == (data.shape[0], 8)
    assert stats.backend == "nndescent" and stats.rounds >= 1
