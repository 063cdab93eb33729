"""The port's graph sampler (``data/graph_sampler.py``) against the
reference's, array for array and bit for bit: the triplets under and over
the cap, the geometric graphs, ``make_dimenet_batch`` with ``z`` and with
``x``, the sharded triplets, the CSR fan-out sampler and the sampled
minibatch at the reference's ``test_gnn_minibatch_sampler_path`` shape.
Then ``graph_to_device`` and ``data.synthetic.random_graph``'s
properties."""
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import graph_sampler as JG
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import graph_sampler as G
from repro_torch.data import random_graph

# the reference's tests/test_smoke_archs.py::test_gnn_minibatch_sampler_path
MINI = dict(n_nodes=600, n_edges=1200, n_triplets=2400, d_feat=16,
            batch_nodes=32, fanout=(5, 3))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got, want):
    """Equal arrays: shapes, dtypes and every bit."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _edges(seed, n=24, e=70):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = ((src + 1 + rng.integers(0, n - 1, e)) % n).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("n_triplets", [1000, 60], ids=["under", "over"])
def test_build_triplets_equal_the_reference(n_triplets):
    src, dst = _edges(0)
    got = G.build_triplets(src, dst, n_triplets, np.random.default_rng(3))
    want = JG.build_triplets(src, dst, n_triplets, np.random.default_rng(3))
    _same(got, want)
    n_real = int((got[0] >= 0).sum())
    assert (n_real < n_triplets) == (n_triplets == 1000)
    _same(G.build_triplets(src, dst, n_triplets),
          JG.build_triplets(src, dst, n_triplets))


def test_random_geometric_graph_equals_the_reference():
    _same(G.random_geometric_graph(np.random.default_rng(4), 40, 6),
          JG.random_geometric_graph(np.random.default_rng(4), 40, 6))


@pytest.mark.parametrize("kw", [
    dict(seed=0, n_nodes=48, n_edges=96, n_triplets=256, n_graphs=4),
    dict(seed=1, n_nodes=40, n_edges=64, n_triplets=100, d_feat=8,
         node_targets=True),
    dict(seed=2, n_nodes=30, n_edges=300, n_triplets=2000, n_graphs=3)],
    ids=["z-graphs", "x-nodes-capped", "z-padded"])
def test_make_dimenet_batch_equals_the_reference(kw):
    got = G.make_dimenet_batch(**kw)
    _same(got, JG.make_dimenet_batch(**kw))
    assert ("x" in got) == bool(kw.get("d_feat"))
    assert got["src"].shape == (kw["n_edges"],)
    assert got["t_kj"].shape == (kw["n_triplets"],)


def test_build_triplets_sharded_equals_the_reference():
    src, dst = _edges(5, n=30, e=96)
    got = G.build_triplets_sharded(src, dst, 120, 4, 24,
                                   np.random.default_rng(6))
    want = JG.build_triplets_sharded(src, dst, 120, 4, 24,
                                     np.random.default_rng(6))
    _same(got, want)
    # indices are shard-local: each block's ids stay below e_per_shard
    assert int(got[0].max()) < 24


def test_csr_and_fanout_sample_equal_the_reference():
    src, dst = _edges(7, n=64, e=400)
    g, jg = G.CSRGraph(64, src, dst), JG.CSRGraph(64, src, dst)
    _same((g.dst, g.offsets), (jg.dst, jg.offsets))
    for u in (0, 17, 63):
        _same(g.neighbors(u), jg.neighbors(u))
    seeds = np.array([3, 9, 40], np.int64)
    _same(G.fanout_sample(g, seeds, (4, 2), np.random.default_rng(8)),
          JG.fanout_sample(jg, seeds, (4, 2), np.random.default_rng(8)))


def test_sampled_dimenet_batch_equals_the_reference():
    got = G.sampled_dimenet_batch(0, ShapeConfig("mini", "train", **MINI),
                                  base_nodes=512, base_degree=8)
    want = JG.sampled_dimenet_batch(
        0, JShapeConfig("mini", "train", **MINI), base_nodes=512,
        base_degree=8)
    _same(got, want)
    assert got["src"].shape == (1200,) and got["t_kj"].shape == (2400,)


def test_graph_to_device_types():
    g = G.make_dimenet_batch(0, n_nodes=16, n_edges=32, n_triplets=64,
                             n_graphs=2)
    t = G.graph_to_device({**g, "n": 3}, "cpu")
    assert t["n"] == 3
    assert t["src"].dtype == torch.int32 and t["z"].dtype == torch.int32
    assert t["edge_mask"].dtype == torch.bool
    assert t["pos"].dtype == torch.float32
    for k, v in g.items():
        assert np.array_equal(t[k].numpy(), v)


def test_random_graph_properties():
    gen = torch.Generator().manual_seed(0)
    g = random_graph(gen, 50, 400, d_feat=6, positions=True)
    assert g["n_nodes"] == 50
    assert g["src"].dtype == torch.int32 and g["src"].shape == (400,)
    assert int(g["src"].min()) >= 0 and int(g["src"].max()) < 50
    assert int(g["dst"].min()) >= 0 and int(g["dst"].max()) < 50
    assert not bool((g["src"] == g["dst"]).any())       # no self-loops
    assert g["x"].shape == (50, 6) and g["pos"].shape == (50, 3)
    assert abs(float(g["pos"].std()) - 2.0) < 0.4
    # dst - src - 1 (mod n) is uniform over [0, n - 2]
    r = (g["dst"] - g["src"] - 1) % 50
    assert int(r.max()) <= 48 and len(torch.unique(r)) > 40
    again = random_graph(torch.Generator().manual_seed(0), 50, 400,
                         d_feat=6, positions=True)
    assert all(torch.equal(g[k], again[k]) for k in ("src", "dst", "x",
                                                     "pos"))
    bare = random_graph(torch.Generator().manual_seed(1), 5, 20)
    assert set(bare) == {"src", "dst", "n_nodes"}
