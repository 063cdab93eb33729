"""The table-derived NSG pools against the reference's, and the whole
pipeline with its default backends.

On integer data every distance is exact in f32, so the reverse table, the
pools (ids, dists and evaluation counts) and a build through them must
equal the reference's exactly; on float data the pools' distances are
held to rtol 1e-6 (the diff-square sum runs in another order). The
pipeline with all-default backends (table pools, device finish; NN-Descent
with the AntiHub-subset reuse where asked) must reach the reference's
recall@10 within a margin pinned from a measured run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build.pools import _reverse_table as jax_reverse_table
from repro.core.build.pools import default_hop_fanout as jax_hop_fanout
from repro.core.build.pools import nnd_candidate_pools as jax_pools
from repro.core.flat import recall_at_k
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro.core.nsg import build_nsg as jax_build_nsg
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro_torch.core.build.finish import reachable_from
from repro_torch.core.build.pools import (
    _reverse_table, default_hop_fanout, nnd_candidate_pools,
)
from repro_torch.core.nsg import build_nsg
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex

# recall@10 gaps measured between the two packages on ``ann_data`` (2000 x
# 32, 48 queries): 0.0 with the default backends (exact kNN below 8192
# rows, table pools, device finish: the same graph), 0.0021 with
# NN-Descent and AntiHub 0.9 (0.8771 against the reference's 0.8792: the
# draws differ); pinned at 0.005
RECALL_MARGIN = 0.005


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def table():
    """Integer data, its exact kNN table with holes (-1 / inf), the
    table's distances."""
    data = np.random.default_rng(0).integers(0, 16, (700, 8)).astype(
        np.float32)
    d, i = jax_knn_graph(jnp.asarray(data), 12)
    ids = np.array(i)
    ids[np.random.default_rng(1).random(ids.shape) < 0.1] = -1
    dists = np.where(ids >= 0, np.array(d), np.inf).astype(np.float32)
    return data, ids.astype(np.int32), dists


def test_default_hop_fanout():
    for k in (1, 4, 12, 32, 64):
        for c in (8, 24, 64, 200):
            assert default_hop_fanout(k, c) == jax_hop_fanout(k, c)


@pytest.mark.parametrize("rev_slots", [3, 12, 64])   # few slots: collisions
def test_reverse_table_equals_reference(table, rev_slots):
    _, ids, dists = table
    want = jax_reverse_table(jnp.asarray(ids), jnp.asarray(dists), rev_slots)
    got = _reverse_table(_t(ids), _t(dists), rev_slots)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("n_candidates,chunk,hop", [(24, 128, None),
                                                    (16, 700, 2),
                                                    (40, 300, 12)])
def test_pools_equal_reference(table, n_candidates, chunk, hop):
    data, ids, dists = table
    wi, wd, we = jax_pools(jnp.asarray(data), jnp.asarray(ids),
                           jnp.asarray(dists), n_candidates, chunk=chunk,
                           hop_fanout=hop, merge_backend="jnp")
    gi, gd, ge = nnd_candidate_pools(_t(data), _t(ids), _t(dists),
                                     n_candidates, chunk=chunk,
                                     hop_fanout=hop)
    _eq(gi, wi)
    _eq(gd, wd)
    assert ge == we > 0


def test_pools_on_float_data():
    data = np.random.default_rng(2).standard_normal((500, 16)).astype(
        np.float32)
    d, i = jax_knn_graph(jnp.asarray(data), 10)
    wi, wd, we = jax_pools(jnp.asarray(data), i, d, 24, chunk=128,
                           merge_backend="jnp")
    gi, gd, ge = nnd_candidate_pools(_t(data), _t(i), _t(d), 24, chunk=128)
    _eq(gi, wi)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    assert ge == we


@pytest.mark.parametrize("with_dists", [True, False])
def test_build_nsg_with_table_pools(table, with_dists):
    """``pools_backend="auto"`` with the table's dists, and
    ``"nndescent"`` without them (recomputed, counted in pool_evals)."""
    data, ids, dists = table
    kw = dict(degree=8, n_candidates=24, chunk=256, with_stats=True,
              pools_backend="auto" if with_dists else "nndescent")
    want, ws = jax_build_nsg(jnp.asarray(data), jnp.asarray(ids),
                             knn_dists=jnp.asarray(dists) if with_dists
                             else None, merge_backend="jnp", **kw)
    got, gs = build_nsg(_t(data), _t(ids),
                        knn_dists=_t(dists) if with_dists else None, **kw)
    _eq(got.neighbors, want.neighbors)
    assert int(got.medoid) == int(want.medoid)
    assert (gs.pools_backend, gs.finish_backend) == ("nndescent", "device")
    assert gs[:5] == ws[:5] and gs.repair_rounds == ws.repair_rounds
    assert reachable_from(got.neighbors.numpy(), int(got.medoid)).all()


@pytest.mark.parametrize("extra", [
    {},                                                  # every default
    dict(antihub_keep=0.9, ep_clusters=8, knn_backend="nndescent",
         graph_degree=12, build_knn_k=16, build_candidates=32,
         ef_search=32),                                  # subset reuse
])
def test_default_backends_fit_and_serve(ann_data, extra):
    params = dict(pca_dim=24, **extra)
    ref = JaxTunedGraphIndex(JaxIndexParams(**params)).fit(ann_data["data"])
    idx = TunedGraphIndex(IndexParams(**params), device="cpu").fit(
        _t(ann_data["data"]))
    assert idx.build_stats.pools_backend == "nndescent"
    assert idx.build_stats.finish_backend == "device"
    assert idx.knn_seconds > 0
    knn = "nndescent" if extra else "exact"
    assert idx.knn_stats["knn"].backend == knn
    if extra:      # the raw table seeds the subset's: one pass, 3 rounds
        assert idx.knn_stats["antihub"].backend == "nndescent"
        assert idx.knn_stats["knn"].rounds <= 3
        assert idx.knn_stats["knn"].n == idx.ntotal
    _, pi = idx.search(_t(ann_data["queries"]), 10)
    _, ji = ref.search(ann_data["queries"], 10)
    truth = ann_data["true_i"]
    r_port = float(recall_at_k(pi.numpy(), truth))
    r_ref = float(recall_at_k(np.asarray(ji), truth))
    assert r_port >= r_ref - RECALL_MARGIN, (r_port, r_ref)
    assert reachable_from(idx.graph.neighbors.numpy(),
                          int(idx.graph.medoid)).all()
