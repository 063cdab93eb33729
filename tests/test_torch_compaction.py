"""Active-query compaction (``core/beam_search.beam_search_compacted``)
against the port's uncompacted search and the reference's.

The bucket helpers (``serve/batching.pow2_buckets`` / ``bucket_for``) equal
the reference's. The compacted search runs over a kNN graph the reference
built over integer data, in f32 and under pq and int8 LUTs of integer
entries, so every distance is exact in both packages: ids, dists, hops,
gathered and dup_gathered must equal the port's uncompacted fused search
and the reference's uncompacted ``beam_search(layout="batched")``, and
``wasted_hops`` must not exceed the uncompacted run's. (Not the reference's
compacted f32 run: it fails its own parity test, ROADMAP Queue 3 item 4.)
The batch sizes each slice ran at are powers of two and never grow. Then
the entry points that serve it: ``TunedGraphIndex.search(...,
compact_every=)``, ``AnnObjective`` with ``compact_every`` and the tune
CLI's ``--patience`` / ``--eps`` / ``--compact-every``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro.serve.batching import bucket_for as jax_bucket_for
from repro.serve.batching import pow2_buckets as jax_pow2_buckets
from repro_torch.core import pipeline
from repro_torch.core.beam_search import beam_search, \
    beam_search_compacted
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
from repro_torch.core.tuning import AnnObjective
from repro_torch.launch import tune as tune_cli
from repro_torch.serve.batching import bucket_for, pow2_buckets

NQ, M = 40, 8          # 40 queries: the first bucket (64) has spare lanes


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("max_batch,min_bucket",
                         [(1, 1), (5, 1), (64, 1), (1000, 4), (37, 64)])
def test_buckets_equal_reference(max_batch, min_bucket):
    got = pow2_buckets(max_batch, min_bucket)
    assert got == jax_pow2_buckets(max_batch, min_bucket)
    for n in range(1, max_batch + 1):
        assert bucket_for(n, got) == jax_bucket_for(n, got)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        bucket_for(got[-1] + 1, got)
    with pytest.raises(ValueError, match="max_batch"):
        pow2_buckets(0)


@pytest.fixture(scope="module")
def case():
    """Integer data, a reference kNN graph with -1 pads, integer queries
    and entries; per backend the search's operands (the queries and base,
    or a LUT of small integers and random codes)."""
    rng = np.random.default_rng(0)
    data = rng.integers(-3, 4, (600, M)).astype(np.float32)
    nbrs = np.array(jax_knn_graph(jnp.asarray(data), 10)[1])
    nbrs[::7, 8:] = -1
    queries = rng.integers(-3, 4, (NQ, M)).astype(np.float32)
    entry = rng.integers(0, 600, NQ).astype(np.int32)
    quant = {b: dict(codes=rng.integers(0, 256, (600, M)).astype(np.uint8),
                     lut=rng.integers(0, 4, (NQ, M, 256)).astype(np.float32))
             for b in ("pq", "int8")}
    return data, nbrs, queries, entry, quant


def _operands(case, backend, to):
    data, nbrs, queries, entry, quant = case
    kw = {} if backend == "f32" else dict(
        dist_backend=backend, **{k: to(v) for k, v in
                                 quant[backend].items()})
    return [to(a) for a in (queries, data, nbrs, entry)], kw


@pytest.fixture(scope="module")
def reference(case):
    """The reference's uncompacted batched search per (backend, patience),
    run once each: [dists, ids, hops, gathered, dup_gathered, wasted]."""
    cache = {}

    def run(backend, patience):
        if (backend, patience) not in cache:
            args, kw = _operands(case, backend, jnp.asarray)
            out = jax_beam_search(*args, **kw, ef=16, k=10, layout="batched",
                                  hop_backend="staged", gather_backend="jnp",
                                  patience=patience, with_stats=True)
            cache[backend, patience] = [np.asarray(a) for a in
                                        out[:2] + tuple(out[2])]
        return cache[backend, patience]
    return run


@pytest.mark.parametrize("compact_every", [1, 4])
@pytest.mark.parametrize("patience", [None, 3])
@pytest.mark.parametrize("backend", ["f32", "pq", "int8"])
def test_compacted_equals_uncompacted_and_reference(case, reference, backend,
                                                    patience, compact_every):
    args, kw = _operands(case, backend, torch.from_numpy)
    kw.update(ef=16, k=10, patience=patience, with_stats=True)
    plain = beam_search(*args, hop_backend="fused", **kw)
    log = []
    syncs = beam_search.host_syncs
    got = beam_search_compacted(*args, compact_every=compact_every,
                                shape_log=log, **kw)
    assert beam_search.host_syncs - syncs == len(log)  # one read per slice
    want = reference(backend, patience)
    for g, p, w in zip(got[:2] + tuple(got[2][:3]),
                       plain[:2] + tuple(plain[2][:3]), want):
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), w)
    # wasted: what the reference's uncompacted search and the port's agree
    # on, and what compaction cuts
    np.testing.assert_array_equal(plain[2].wasted_hops.numpy(), want[5])
    assert (got[2].wasted_hops <= plain[2].wasted_hops).all()
    assert int(got[2].wasted_hops.sum()) < int(plain[2].wasted_hops.sum())
    assert log[0] == 64 and all(b & (b - 1) == 0 for b in log)
    assert all(a >= b for a, b in zip(log, log[1:])) and log[-1] < 64
    # without stats: (dists, ids, hops)
    d, i, h = beam_search_compacted(
        *args, compact_every=compact_every,
        **{k: v for k, v in kw.items() if k != "with_stats"})
    assert torch.equal(i, got[1]) and torch.equal(h, got[2].hops)


def test_compacted_refuses_what_the_reference_refuses(case):
    args, _ = _operands(case, "f32", torch.from_numpy)
    kw = dict(ef=16, k=10, compact_every=4)
    with pytest.raises(ValueError, match="mode='while'"):
        beam_search_compacted(*args, mode="fori", **kw)
    with pytest.raises(ValueError, match="compact_every"):
        beam_search_compacted(*args, **dict(kw, compact_every=0))
    with pytest.raises(ValueError, match="eps"):
        beam_search_compacted(*args, eps=-1.0, **kw)
    with pytest.raises(ValueError, match="patience"):
        beam_search_compacted(*args, patience=0, **kw)
    with pytest.raises(ValueError, match="codes and lut"):
        beam_search_compacted(*args, dist_backend="pq", **kw)


INDEX_PARAMS = dict(pca_dim=M, antihub_keep=1.0, ep_clusters=1,
                    ef_search=16, graph_degree=8, build_knn_k=8,
                    build_candidates=16, knn_backend="exact",
                    finish_backend="host", hop_backend="fused")


@pytest.fixture(scope="module")
def index(case):
    return TunedGraphIndex(IndexParams(**INDEX_PARAMS), device="cpu").fit(
        torch.from_numpy(case[0]))


@pytest.mark.parametrize("backend", ["f32", "pq"])
def test_index_search_compacted(case, index, backend):
    q = torch.from_numpy(case[2])
    kw = dict(dist_backend=backend, rerank=16, patience=4)
    d0, i0 = index.search(q, 10, **kw)
    stats0 = index.search_stats()
    assert index.last_compaction_shapes is None
    d1, i1 = index.search(q, 10, compact_every=2, **kw)
    stats1 = index.search_stats()
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    for key in ("hops", "gathered", "dup_gathered"):
        assert stats1[key] == stats0[key]
    assert stats1["wasted_hops"] < stats0["wasted_hops"]
    assert index.last_compaction_shapes[0] == 64
    # the params' compact_every is the default
    idx = index.with_graph(index.graph)
    idx.params = IndexParams(**dict(INDEX_PARAMS, compact_every=2))
    d2, i2 = idx.search(q, 10, **kw)
    assert torch.equal(i2, i1) and idx.last_compaction_shapes == \
        index.last_compaction_shapes


def test_ann_objective_serves_compact_every(case):
    data, queries = (torch.from_numpy(a) for a in case[:3:2])
    obj = AnnObjective(data, queries, k=10,
                       base_params=IndexParams(**INDEX_PARAMS),
                       qps_repeats=1, device="cpu")
    trial = dict(ef_search=16, patience=4)
    plain = obj.evaluate(trial)
    compacted = obj.evaluate(dict(trial, compact_every=4))
    assert compacted.recall == plain.recall and compacted.cached_build
    assert obj.eval_log[-1][0]["compact_every"] == 4


def test_tune_cli_serving_flags(monkeypatch, capsys):
    calls = []
    real = pipeline.beam_search_compacted

    def counted(*a, **kw):
        calls.append(kw["compact_every"])
        return real(*a, **kw)
    monkeypatch.setattr(pipeline, "beam_search_compacted", counted)
    tune_cli.main(["--device", "cpu", "--n", "200", "--dim", "8",
                   "--queries", "8", "--trials", "2", "--patience", "8",
                   "--eps", "0.5", "--compact-every", "8"])
    assert "-- build log (2 evals) --" in capsys.readouterr().out
    assert calls and set(calls) == {8}
    args = tune_cli._parser().parse_args(["--patience", "8", "--eps", "0.5",
                                          "--compact-every", "8"])
    assert (args.patience, args.eps, args.compact_every) == (8, 0.5, 8)
