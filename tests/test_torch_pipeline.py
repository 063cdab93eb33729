"""The port's TunedGraphIndex against the reference's, end to end.

1. An index the reference built (PCA, AntiHub 0.9, 8 entry points, exact
   kNN, host finish) is carried across with ``index_from_jax_state``; both
   packages search it. Both default to the staged hop with the dot-formula
   gather on the CPU, whose rounding error is relative to |q|^2 + |x|^2,
   so dists are held to 1e-5 of that sum; ids to >= 99% of rows, the total
   hop count to 1%.
2. The port's own ``fit`` on the same data and params reaches the
   reference's recall@10 to within 0.01, with a graph reachable from the
   medoid and no row above the degree.
"""
import numpy as np
import pytest
import torch

from repro.core.flat import recall_at_k
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro_torch.carry import index_from_jax_state
from repro_torch.core.build.finish import reachable_from
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex

PARAMS = dict(pca_dim=24, antihub_keep=0.9, ep_clusters=8, ef_search=32,
              graph_degree=12, build_knn_k=16, build_candidates=32,
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


@pytest.fixture(scope="module")
def jax_index(ann_data):
    return JaxTunedGraphIndex(JaxIndexParams(**PARAMS)).fit(ann_data["data"])


@pytest.fixture(scope="module")
def carried(jax_index):
    state = jax_index.state_dict()
    state["arrays"] = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return index_from_jax_state(state, device="cpu")


def _queries(ann_data):
    return torch.from_numpy(np.array(ann_data["queries"]))


def test_carried_index_searches_like_the_reference(jax_index, carried,
                                                   ann_data):
    jd, ji = jax_index.search(ann_data["queries"], 10)
    pd, pi = carried.search(_queries(ann_data), 10)
    jd, ji, pd, pi = (np.asarray(a) for a in (jd, ji, pd, pi))
    q = carried.project(_queries(ann_data)).numpy()
    base = carried.base.numpy()
    norms = (q ** 2).sum(1)[:, None] + (base ** 2).sum(1).max()
    assert (np.abs(pd - jd) <= 1e-5 * norms + 1e-5).all()
    assert (pi == ji).all(1).mean() >= 0.99
    jh = jax_index.search_stats()["hops"]
    assert abs(carried.search_stats()["hops"] - jh) <= 0.01 * jh
    assert carried.memory_bytes() == jax_index.memory_bytes()


def test_port_state_round_trips(carried, ann_data, jax_index):
    state = carried.state_dict()
    again = TunedGraphIndex.from_state(state, device="cpu")
    d1, i1 = carried.search(_queries(ann_data), 10)
    d2, i2 = again.search(_queries(ann_data), 10)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    # the reference loads the port's state too
    back = JaxTunedGraphIndex.from_state(state)
    _, ij = back.search(ann_data["queries"], 10)
    assert (np.asarray(ij) == i1.numpy()).all(1).mean() >= 0.99


def test_port_fit_reaches_reference_recall(jax_index, ann_data):
    data = torch.from_numpy(np.array(ann_data["data"]))
    idx = TunedGraphIndex(IndexParams(**PARAMS), device="cpu").fit(
        data, torch.Generator().manual_seed(0))
    _, pi = idx.search(_queries(ann_data), 10)
    _, ji = jax_index.search(ann_data["queries"], 10)
    truth = ann_data["true_i"]
    r_port = float(recall_at_k(pi.numpy(), truth))
    r_ref = float(recall_at_k(np.asarray(ji), truth))
    assert r_port >= r_ref - 0.01, (r_port, r_ref)
    nb = idx.graph.neighbors.numpy()
    assert reachable_from(nb, int(idx.graph.medoid)).all()
    assert ((nb >= 0).sum(1) <= PARAMS["graph_degree"]).all()
    assert set(idx.stage_seconds) == {"antihub", "pca", "knn", "pools",
                                      "prune", "finish", "entry_points"}


def test_unported_options_raise_and_default_device(ann_data):
    data = torch.from_numpy(np.array(ann_data["data"]))
    # all-default backends (table pools, device finish) now fit and serve
    auto = TunedGraphIndex(IndexParams(pca_dim=32), device="cpu").fit(data)
    assert auto.build_stats.pools_backend == "nndescent"
    assert auto.build_stats.finish_backend == "device"
    _, ids = auto.search(_queries(ann_data), 10)
    assert ids.shape == (len(ann_data["queries"]), 10)
    # the compacted search is ported too: a pq index with compact_every
    # fits and serves through it
    compacted = IndexParams(**{**PARAMS, "dist_backend": "pq",
                               "compact_every": 4})
    cidx = TunedGraphIndex(compacted, device="cpu").fit(data)
    _, ids = cidx.search(_queries(ann_data), 10)
    assert ids.shape == (len(ann_data["queries"]), 10)
    assert cidx.last_compaction_shapes[0] == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TunedGraphIndex(IndexParams(**PARAMS))
