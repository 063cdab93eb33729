"""The port's tuner slice against the reference's.

1. Samplers and the study: one seed and one scripted objective (identical
   values and constraints fed to both packages) give identical parameter
   sequences (RandomSampler; TPESampler single- and multi-objective).
2. Rebuild-free derivation on a graph the reference built on integer data
   (symmetric coordinates in [-3, 3], so every distance and the medoid are
   exact in both packages): ``reprune``, ``reprune_family`` (both forms,
   the packed masks bit for bit, ``member(i, d)``), ``nsg_from_neighbors``
   (host repair) and, on the carried index, ``TunedGraphIndex.reprune`` /
   ``with_graph`` and ``fit(..., antihub_knn_ids=)`` are held exactly.
   AntiHub keeps 512 of the 600 rows, a power of two, so the kept rows'
   mean (the medoid's anchor) is exact too.
3. Batched search with ``patience``/``eps`` against the reference's
   ``beam_search(layout="batched", hop_backend="staged")``: ids, dists,
   hops and every counter exactly equal, for each port hop.
4. ``AnnObjective`` end to end at N=800, D=16: one fixed trial list in
   both packages gives identical cache behaviour (cached/repruned flags,
   structural builds, family passes, grid hits, snapped alphas); recall
   within a margin pinned from a measured reference run (the builds' random
   draws differ).
5. ``python -m repro_torch.launch.tune --device cpu`` runs the paper's
   pipeline tuner and prints its report; its defaults resolve to the device
   finishing pass, which raises naming its ROADMAP item.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.build import nsg_from_neighbors as jax_nsg_from_neighbors
from repro.core.build import reprune as jax_reprune
from repro.core.build import reprune_family as jax_reprune_family
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro.core.pipeline import \
    structural_build_count as jax_structural_build_count
from repro.core.tuning import AnnObjective as JaxAnnObjective
from repro.core.tuning import RandomSampler as JaxRandomSampler
from repro.core.tuning import Study as JaxStudy
from repro.core.tuning import TPESampler as JaxTPESampler
from repro.core.tuning import default_space as jax_default_space
from repro.data import clustered_vectors as jax_clustered_vectors
from repro.data import queries_like as jax_queries_like
from repro_torch.carry import index_from_jax_state
from repro_torch.core.beam_search import beam_search
from repro_torch.core.build import (
    nsg_from_neighbors, reprune, reprune_family, reprune_nsg,
)
from repro_torch.core.build.finish import reachable_from
from repro_torch.core.pipeline import (
    IndexParams, TunedGraphIndex, structural_build_count,
)
from repro_torch.core.tuning import (
    AnnObjective, RandomSampler, Study, TPESampler, default_space,
)
from repro_torch.launch import tune as tune_cli

ROOT = Path(__file__).resolve().parents[1]


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


# -- 1. samplers -------------------------------------------------------------

def _scripted(multi):
    """One objective for both packages: values and constraints computed in
    numpy from the suggested params alone."""
    def objective(trial):
        p = trial.params
        x = (np.log(p["ef_search"]) - 0.3 * p["graph_degree"] / 8
             + 2.0 * (p["alpha"] - 1.2) ** 2 - p["antihub_keep"]
             + 0.01 * p["pca_dim"] + 0.05 * p["patience"]
             + (0.2 if p["hop_backend"] == "fused" else 0.0))
        recall = float(1.0 / (1.0 + np.exp(-x)))
        qps = float(1000.0 / (1.0 + x * x) + 7 * np.log(p["ep_clusters"]))
        if multi:
            return {"values": (qps, recall), "constraints": []}
        return {"values": qps, "constraints": [0.7 - recall]}
    return objective


@pytest.mark.parametrize("kind", ["random", "tpe-single", "tpe-multi"])
def test_samplers_suggest_identical_sequences(kind):
    multi = kind == "tpe-multi"
    studies = []
    for space_fn, sampler_cls, study_cls in (
            (jax_default_space, (JaxRandomSampler, JaxTPESampler), JaxStudy),
            (default_space, (RandomSampler, TPESampler), Study)):
        space = space_fn(32, 2000, max_degree=16)
        sampler = (sampler_cls[0](seed=3) if kind == "random"
                   else sampler_cls[1](seed=5, n_startup=4))
        study = study_cls(space, sampler, n_objectives=2 if multi else 1)
        study.optimize(_scripted(multi), n_trials=14)
        studies.append(study)
    ref, port = studies
    assert [t.params for t in port.trials] == [t.params for t in ref.trials]
    assert [t.values for t in port.trials] == [t.values for t in ref.trials]
    if multi:
        assert [t.number for t in port.pareto_front()] == \
            [t.number for t in ref.pareto_front()]
    else:
        assert port.best_trial.number == ref.best_trial.number


# -- 2. rebuild-free derivation -----------------------------------------------

KEEP = 0.85333          # ceil(0.85333 * 600) = 512 kept rows
IDX_PARAMS = dict(pca_dim=8, antihub_keep=KEEP, ep_clusters=1, ef_search=32,
                  graph_degree=12, build_knn_k=12, build_candidates=24,
                  knn_backend="exact", finish_backend="host")


@pytest.fixture(scope="module")
def int_data():
    half = np.random.default_rng(0).integers(-3, 4, (300, 8)).astype(
        np.float32)
    return np.concatenate([half, -half])


@pytest.fixture(scope="module")
def antihub_table(int_data):
    return np.array(jax_knn_graph(jnp.asarray(int_data), 10)[1])


@pytest.fixture(scope="module")
def jax_index(int_data, antihub_table):
    return JaxTunedGraphIndex(JaxIndexParams(**IDX_PARAMS)).fit(
        jnp.asarray(int_data), antihub_knn_ids=jnp.asarray(antihub_table))


@pytest.fixture(scope="module")
def carried(jax_index):
    state = jax_index.state_dict()
    state["arrays"] = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return index_from_jax_state(state, device="cpu")


def _port_graph(jax_index):
    return (torch.from_numpy(np.array(jax_index.base)),
            torch.from_numpy(np.array(jax_index.graph.neighbors)))


@pytest.mark.parametrize("alpha,degree", [(1.0, None), (1.1, 6),
                                          (1.25, 4), (1.4, 12)])
def test_reprune_exact(jax_index, alpha, degree):
    base, nbrs = _port_graph(jax_index)
    want = jax_reprune(jax_index.base, jax_index.graph.neighbors,
                       alpha=alpha, degree=degree, chunk=128)
    got = reprune(base, nbrs, alpha=alpha, degree=degree, chunk=128)
    _eq(got, want)
    if alpha == 1.0 and degree is None:      # alpha=1 keeps every edge
        _eq(got, jax_index.graph.neighbors)


@pytest.mark.parametrize("materialize", [True, False])
def test_reprune_family_exact(jax_index, materialize):
    alphas = (1.0, 1.05, 1.2, 1.35)
    base, nbrs = _port_graph(jax_index)
    want = jax_reprune_family(jax_index.base, jax_index.graph.neighbors,
                              alphas, chunk=128, materialize=materialize)
    got = reprune_family(base, nbrs, alphas, chunk=128,
                         materialize=materialize)
    if materialize:
        _eq(got, want)
        return
    # the packed survivor words, bit for bit (the port holds them as int32)
    _eq(got.masks.numpy().view(np.uint32), want.masks)
    _eq(got.cand_ids, want.cand_ids)
    assert got.shape == want.shape and got.nbytes() == want.nbytes()
    for i, a in enumerate(alphas):
        for d in (3, 7, 12):
            member = got.member(i, d)
            _eq(member, want.member(i, d))
            _eq(member, reprune(base, nbrs, alpha=a, degree=d, chunk=128))
    _eq(got.materialize(), want.materialize())


def test_nsg_from_neighbors_host_repair_exact(jax_index):
    base, nbrs = _port_graph(jax_index)
    pruned = jax_reprune(jax_index.base, jax_index.graph.neighbors,
                         alpha=1.3, degree=4, chunk=128)
    want = jax_nsg_from_neighbors(jax_index.base, pruned,
                                  jax_index.graph.medoid,
                                  knn_ids=jax_index.knn_ids,
                                  finish_backend="host")
    got = nsg_from_neighbors(base, torch.from_numpy(np.array(pruned)),
                             torch.tensor(int(jax_index.graph.medoid)),
                             knn_ids=torch.from_numpy(
                                 np.array(jax_index.knn_ids)),
                             finish_backend="host")
    _eq(got.neighbors, want.neighbors)
    assert int(got.medoid) == int(want.medoid)
    assert reachable_from(got.neighbors.numpy(), int(got.medoid)).all()


def test_index_reprune_and_with_graph_exact(jax_index, carried, int_data):
    before = structural_build_count()
    want = jax_index.reprune(alpha=1.15, degree=6)
    got = carried.reprune(alpha=1.15, degree=6)
    _eq(got.graph.neighbors, want.graph.neighbors)
    assert (got.params.alpha, got.params.graph_degree) == \
        (want.params.alpha, want.params.graph_degree)
    assert got.base is carried.base and carried.graph.neighbors.shape[1] == 12
    direct = reprune_nsg(carried.base, carried.graph, alpha=1.15, degree=6,
                         knn_ids=carried.knn_ids, finish_backend="host")
    _eq(got.graph.neighbors, direct.neighbors)
    # with_graph: the carried index serving the derived graph searches
    # like the reference's derived index (integer queries: exact)
    q = np.random.default_rng(2).integers(-3, 4, (30, 8)).astype(np.float32)
    served, ref_served = carried.with_graph(got.graph), \
        jax_index.with_graph(want.graph)
    wd, wi = ref_served.search(jnp.asarray(q), 10)
    gd, gi = served.search(torch.from_numpy(q), 10)
    _eq(gi, wi)
    _eq(gd, wd)
    assert served.search_stats() == ref_served.search_stats()
    assert structural_build_count() == before


def test_fit_with_antihub_table_exact(jax_index, int_data, antihub_table):
    before = structural_build_count()
    data = torch.from_numpy(int_data)
    got = TunedGraphIndex(IndexParams(**IDX_PARAMS), device="cpu").fit(
        data, antihub_knn_ids=torch.from_numpy(antihub_table))
    assert structural_build_count() == before + 1
    assert got.ntotal == 512
    _eq(got.kept_idx, jax_index.kept_idx)
    _eq(got.knn_ids, jax_index.knn_ids)
    _eq(got.graph.neighbors, jax_index.graph.neighbors)
    assert int(got.graph.medoid) == int(jax_index.graph.medoid)
    # the table is the one the fit would compute itself
    own = TunedGraphIndex(IndexParams(**IDX_PARAMS), device="cpu").fit(data)
    _eq(own.kept_idx, got.kept_idx)
    _eq(own.graph.neighbors, got.graph.neighbors)


# -- 3. adaptive termination --------------------------------------------------

@pytest.fixture(scope="module")
def int_graph():
    rng = np.random.default_rng(0)
    data = rng.integers(-3, 4, (600, 8)).astype(np.float32)
    nbrs = np.array(jax_knn_graph(jnp.asarray(data), 10)[1])
    nbrs[::7, 8:] = -1
    queries = rng.integers(-3, 4, (40, 8)).astype(np.float32)
    entry = rng.integers(0, 600, 40).astype(np.int32)
    return data, nbrs, queries, entry


# (port hop keywords, the reference's gather of the same arithmetic)
PORT_HOPS = [(dict(hop_backend="staged"), None),
             (dict(hop_backend="staged", gather_backend="kernel"), "jnp"),
             (dict(hop_backend="fused"), "jnp")]


@pytest.mark.parametrize("patience,eps", [(1, 0.0), (4, 0.0), (3, 2.0)])
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_patience_search_exact(int_graph, patience, eps, mode):
    data, nbrs, queries, entry = int_graph
    kw = dict(ef=16, k=10, mode=mode, patience=patience, eps=eps,
              with_stats=True)
    t = [torch.from_numpy(a) for a in (queries, data, nbrs, entry)]
    stock = beam_search(*t, ef=16, k=10, mode=mode, with_stats=True)
    for port_kw, gather in PORT_HOPS:
        jd, ji, js = jax_beam_search(
            jnp.asarray(queries), jnp.asarray(data), jnp.asarray(nbrs),
            jnp.asarray(entry), layout="batched", hop_backend="staged",
            gather_backend=gather, **kw)
        pd, pi, ps = beam_search(*t, **port_kw, **kw)
        _eq(pi, ji)
        _eq(pd, jd)
        for got, want in zip(ps, js):      # hops, gathered, dup, wasted
            _eq(got, want)
    # adaptive termination stops lanes early: fewer hops than the stock run
    assert int(ps.hops.sum()) < int(stock[2].hops.sum())


@pytest.mark.parametrize("mode", ["while", "fori"])
def test_patience_none_is_the_stock_search(int_graph, mode):
    """patience=None keeps the stock rule; a patience above the hop budget
    never binds, so it gives the same bits."""
    data, nbrs, queries, entry = int_graph
    t = [torch.from_numpy(a) for a in (queries, data, nbrs, entry)]
    kw = dict(ef=16, k=10, mode=mode, with_stats=True)
    a = beam_search(*t, **kw)
    b = beam_search(*t, patience=10 ** 6, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


# -- 4. AnnObjective ----------------------------------------------------------

OBJ_BASE = dict(pca_dim=16, graph_degree=8, build_knn_k=8,
                build_candidates=16, ef_search=32, knn_backend="exact",
                finish_backend="host")
TRIALS = [
    dict(pca_dim=16, antihub_keep=0.9, graph_degree=8, alpha=1.0,
         ep_clusters=4, ef_search=32, hop_backend="staged", patience=0),
    dict(pca_dim=16, antihub_keep=0.9, graph_degree=6, alpha=1.12,
         ep_clusters=4, ef_search=32, hop_backend="staged", patience=0),
    dict(pca_dim=16, antihub_keep=0.9, graph_degree=8, alpha=1.0,
         ep_clusters=8, ef_search=48, hop_backend="fused", patience=4),
    dict(pca_dim=12, antihub_keep=0.8, graph_degree=8, alpha=1.02,
         ep_clusters=1, ef_search=24, hop_backend="staged", patience=0),
    dict(pca_dim=12, antihub_keep=0.8, graph_degree=5, alpha=1.33,
         ep_clusters=2, ef_search=64, hop_backend="fused", patience=2),
    dict(pca_dim=16, antihub_keep=0.9, graph_degree=6, alpha=1.08,
         ep_clusters=4, ef_search=20, hop_backend="staged", patience=8),
]
# largest per-trial recall gap measured between the two packages on this
# list (0.0525, trial 4: degree 5, alpha 1.35, patience 2), rounded up
RECALL_MARGIN = 0.06


def test_ann_objective_cache_counters_equal_reference():
    data = np.asarray(jax_clustered_vectors(jax.random.PRNGKey(0), 800, 16,
                                            n_clusters=12))
    queries = np.asarray(jax_queries_like(jax.random.PRNGKey(1),
                                          jnp.asarray(data), 40))
    runs = []
    for obj_cls, params_cls, count in (
            (JaxAnnObjective, JaxIndexParams, jax_structural_build_count),
            (AnnObjective, IndexParams, structural_build_count)):
        kw = {} if obj_cls is JaxAnnObjective else {"device": "cpu"}
        conv = jnp.asarray if obj_cls is JaxAnnObjective else (lambda a: a)
        obj = obj_cls(conv(data), conv(queries), k=10,
                      base_params=params_cls(**OBJ_BASE), qps_repeats=1,
                      **kw)
        c0 = count()
        deltas = []
        for p in TRIALS:
            obj.evaluate(p)
            deltas.append(count() - c0)
        runs.append((obj, deltas))
    (ref, ref_deltas), (port, port_deltas) = runs
    assert port_deltas == ref_deltas == [1, 1, 1, 2, 2, 2]
    assert (port.family_prunes, port.grid_hits) == \
        (ref.family_prunes, ref.grid_hits) == (2, 3)
    for (pp, pr), (rp, rr) in zip(port.eval_log, ref.eval_log):
        assert pp == rp                          # snapped alphas included
        assert (pr.cached_build, pr.repruned) == (rr.cached_build,
                                                  rr.repruned)
        assert abs(pr.recall - rr.recall) <= RECALL_MARGIN
        assert pr.qps > 0 and pr.mem_bytes > 0
    assert [p["alpha"] for p, _ in port.eval_log] == \
        [1.0, 1.1, 1.0, 1.0, 1.35, 1.1]


# -- 5. the CLI ---------------------------------------------------------------

def test_tune_cli_runs_the_pipeline_tuner_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
         "--knn-backend", "exact", "--finish-backend", "host", "--n", "600",
         "--dim", "16", "--queries", "32", "--trials", "6",
         "--max-degree", "8", "--mode", "single"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "-- build log (6 evals) --" in out.stdout
    assert "structural builds" in out.stdout
    assert "reprune grid:" in out.stdout


def test_tune_cli_unported_paths_raise(capsys):
    tiny = ["--device", "cpu", "--n", "200", "--dim", "8", "--queries", "8",
            "--trials", "1"]
    tune_cli.main(tiny)              # auto -> the device finish: now runs
    assert "-- build log (1 evals) --" in capsys.readouterr().out
    # --shards runs, with the prenorm toggle too; a non-graph spec has no
    # reprune (as in the reference)
    with pytest.raises(TypeError, match="reprune"):
        tune_cli.main(tiny + ["--spec", "IVF8,Flat", "--shards", "4"])
    tune_cli.main(tiny + ["--shards", "4"])
    assert "(OK — one per shard)" in capsys.readouterr().out
    from repro_torch import flags
    flags.ANN_PRENORM = True
    try:
        tune_cli.main(tiny + ["--shards", "4"])
    finally:
        flags.ANN_PRENORM = False
    assert "(OK — one per shard)" in capsys.readouterr().out
