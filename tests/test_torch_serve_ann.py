"""The port's ANN serving layer: the contracts of the reference's
``test_serve_batching.py`` and ``test_resilience.py`` (the sharded
degraded search is held in ``test_torch_distributed.py``),
``ann_search_step``, and both launchers on the CPU.

* Bucketing is invisible in results: a padded, sliced batch equals the
  unbatched search; the shapes sent to the index stay the warmed buckets.
* Zero lost tickets: every submitted ticket is answered with (dists, ids)
  or a typed ``SearchFailure``.
* ``ResilientSearch`` retries transient faults with backoff, fails fast
  on ``PermanentFault`` and past its deadline; fault schedules depend only
  on (seed, call index).
* ``python -m repro_torch.launch.serve --arch ann-laion`` (bucketed and
  micro-batched by default, ``--buckets off``, ``--snapshot`` /
  ``--restore``) and ``python -m repro_torch.launch.tune --spec`` run with
  ``--device cpu`` and print the reference's lines.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.index_api import SearchParams, build_index
from repro_torch.core.distances import l2_topk
from repro_torch.serve.batching import (
    BucketedSearch, MicroBatchQueue, bucket_for, pow2_buckets,
)
from repro_torch.serve.faults import (
    FaultInjector, InjectedFault, PermanentFault, TransientFault,
)
from repro_torch.serve.resilience import (
    ResilientSearch, SearchFailure, SearchUnavailable,
)
from repro_torch.serve.serve_step import ann_search_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other made this module's many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ann():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((12, 32)) * 0.95 ** np.arange(32)
    data = centers[rng.integers(0, 12, 2000)] + \
        rng.standard_normal((2000, 32)) * 0.95 ** np.arange(32)
    data = torch.from_numpy(data.astype(np.float32))
    queries = data[torch.from_numpy(rng.integers(0, 2000, 48))] + 0.05
    _, true_i = FlatIndex(data).search(queries, 10)
    return {"data": data, "queries": queries, "true_i": true_i}


@pytest.fixture(scope="module")
def served_index(ann):
    return build_index("NSG12,EP8", ann["data"], device="cpu")


def _drain(queue, tickets):
    ok, failed = [], []
    for t in tickets:
        res = queue.take(t)
        (ok if res else failed).append(res)
    return ok, failed


# -------------------------------------------------------------- batching
def test_pow2_buckets_cover_range():
    assert pow2_buckets(64) == (1, 2, 4, 8, 16, 32, 64)
    assert pow2_buckets(48) == (1, 2, 4, 8, 16, 32, 64)
    assert pow2_buckets(1) == (1,)
    assert pow2_buckets(64, min_bucket=8) == (8, 16, 32, 64)
    with pytest.raises(ValueError):
        pow2_buckets(0)


def test_bucket_for_smallest_fit():
    buckets = (1, 2, 4, 8)
    assert bucket_for(1, buckets) == 1
    assert bucket_for(3, buckets) == 4
    assert bucket_for(8, buckets) == 8
    with pytest.raises(ValueError):
        bucket_for(9, buckets)


@pytest.mark.parametrize("n", [1, 3, 5, 17, 32])
def test_bucketed_step_matches_unbatched(ann, n):
    idx = FlatIndex(ann["data"])
    step = ann_search_step(idx, k=10, params=SearchParams(chunk=512),
                           buckets=pow2_buckets(32))
    q = ann["queries"][:n]
    d, i = step(q)
    du, iu = idx.search(q, 10, SearchParams(chunk=512))
    assert d.shape == (n, 10) and i.shape == (n, 10)
    assert torch.equal(i, iu) and torch.equal(d, du)


def test_bucketed_graph_step_matches_unbatched(ann, served_index):
    """A graph index's lanes do not interact: padding leaves every real
    row's answer as it was."""
    step = ann_search_step(served_index, k=10, buckets=pow2_buckets(16))
    q = ann["queries"][:11]
    d, i = step(q)
    du, iu = served_index.search(q, 10)
    assert torch.equal(i, iu) and torch.equal(d, du)


def test_shapes_stay_in_the_warmed_buckets(ann):
    """Ragged sizes sharing a bucket present one shape to the search; after
    warmup every dispatched shape is a bucket."""
    data = ann["data"]
    shapes = []

    def raw(q):
        shapes.append(q.shape[0])
        return l2_topk(q, data, 10)

    bs = BucketedSearch(raw, pow2_buckets(8))
    q = ann["queries"]
    for n in (5, 7, 8, 6, 8):           # all map to bucket 8
        bs(q[:n])
    assert set(shapes) == {8}
    assert set(bs.dispatched) == {8}
    bs.warmup(dim=data.shape[1])        # one call per bucket
    assert shapes[-4:] == [1, 2, 4, 8] and bs.dispatched[-4:] == [1, 2, 4, 8]
    for n in (1, 2, 3, 4, 5, 8):
        bs(q[:n])
    assert set(shapes) <= set(bs.buckets)
    assert set(bs.dispatched) <= set(bs.buckets)


def test_oversized_batch_served_in_max_bucket_runs(ann):
    idx = FlatIndex(ann["data"])
    step = ann_search_step(idx, k=10, buckets=pow2_buckets(8))
    q = ann["queries"][:19]             # 19 > max bucket 8
    d, i = step(q)
    du, iu = idx.search(q, 10)
    assert torch.equal(i, iu)
    assert set(step.dispatched) <= set(step.buckets)
    queue = MicroBatchQueue(step, window_s=10.0)
    ticket = queue.submit(q)
    queue.flush()
    np.testing.assert_array_equal(queue.take(ticket)[1], iu.numpy())
    assert not queue.results            # take() popped it


def test_queue_scatters_results_per_ticket(ann):
    idx = FlatIndex(ann["data"])
    step = ann_search_step(idx, k=10, buckets=pow2_buckets(32))
    queue = MicroBatchQueue(step, window_s=10.0)
    q = ann["queries"]
    slices = [(0, 3), (3, 8), (8, 9), (9, 16)]
    tickets = [queue.submit(q[a:b]) for a, b in slices]
    assert not queue.results            # window not elapsed, no flush yet
    assert queue.maybe_flush() is False
    queue.flush()
    for ticket, (a, b) in zip(tickets, slices):
        _, iu = idx.search(q[a:b], 10)
        np.testing.assert_array_equal(queue.results[ticket][1], iu.numpy())
    stats = queue.latency_stats()
    assert stats["served"] == 16 and stats["flushes"] == 1
    assert stats["mean_occupancy"] == pytest.approx(16 / 16)


def test_queue_flushes_on_window_and_capacity(ann):
    idx = FlatIndex(ann["data"])
    step = ann_search_step(idx, k=10, buckets=pow2_buckets(8))
    queue = MicroBatchQueue(step, window_s=0.0)
    t0 = queue.submit(ann["queries"][:2])
    assert queue.maybe_flush() is True  # zero window -> due immediately
    assert t0 in queue.results
    t1 = queue.submit(ann["queries"][:6])
    t2 = queue.submit(ann["queries"][6:12])     # 6 + 6 > bucket 8
    assert t1 in queue.results          # t1 flushed to make room
    queue.flush()
    assert t2 in queue.results
    assert queue.results[t2][1].shape == (6, 10)


def test_search_stats_pass_through_the_wrappers(ann, served_index):
    step = ann_search_step(served_index, k=10, buckets=pow2_buckets(8),
                           retries=1)
    step(ann["queries"][:5])
    stats = step.search_stats()
    assert stats["hops"] > 0 and set(stats) >= {"wasted_hops",
                                                "active_fraction"}
    assert ann_search_step(FlatIndex(ann["data"])).search_stats() is None


# ------------------------------------------------- zero lost tickets
def test_flush_failure_loses_no_tickets(ann, served_index):
    queries = ann["queries"]
    step = ann_search_step(served_index, k=10, buckets=pow2_buckets(16))
    step.warmup(served_index.dim)
    inj = FaultInjector(fail_calls=(0, 1))      # both attempts of flush 0
    queue = MicroBatchQueue(inj.wrap(step), window_s=0.0, flush_retries=1)
    tickets = [queue.submit(queries[i:i + 4]) for i in range(0, 16, 4)]
    queue.flush()                               # must NOT raise
    ok, failed = _drain(queue, tickets)
    assert not ok and len(failed) == len(tickets)
    for f in failed:
        assert isinstance(f, SearchFailure)
        assert f.error_type == "TransientFault"
        assert f.attempts == 2
    assert queue.results == {}
    stats = queue.latency_stats()
    assert stats["errors"] == len(tickets)
    assert stats["retries"] == 1


def test_flush_retry_recovers_transient(ann, served_index):
    queries = ann["queries"]
    step = ann_search_step(served_index, k=10, buckets=pow2_buckets(16))
    step.warmup(served_index.dim)
    inj = FaultInjector(fail_calls=(0,))        # first attempt only
    queue = MicroBatchQueue(inj.wrap(step), window_s=0.0, flush_retries=1)
    tickets = [queue.submit(queries[i:i + 4]) for i in range(0, 16, 4)]
    queue.flush()
    ok, failed = _drain(queue, tickets)
    assert len(ok) == len(tickets) and not failed
    assert queue.latency_stats()["retries"] == 1
    _, want = served_index.search(queries[:4], 10)
    np.testing.assert_array_equal(ok[0][1], want.numpy())


def test_every_ticket_answered_under_sustained_faults(ann, served_index):
    queries = ann["queries"]
    inj = FaultInjector(seed=42, transient_rate=0.0)
    step = ann_search_step(inj.wrap_index(served_index), k=10,
                           buckets=pow2_buckets(8), retries=2)
    step.warmup(served_index.dim)
    inj.transient_rate = 0.3                    # arm AFTER warmup
    queue = MicroBatchQueue(step, window_s=0.0, flush_retries=1)
    rng = np.random.default_rng(0)
    tickets, row = [], 0
    while row < queries.shape[0]:
        n = min(int(rng.integers(1, 5)), queries.shape[0] - row)
        tickets.append(queue.submit(queries[row:row + n]))
        row += n
        queue.maybe_flush()
    queue.flush()
    ok, failed = _drain(queue, tickets)         # take() KeyErrors if lost
    assert len(ok) + len(failed) == len(tickets)
    assert queue.results == {}
    assert inj.faults_raised > 0


def test_max_queue_sheds_with_typed_failure(ann, served_index):
    queries = ann["queries"]
    step = ann_search_step(served_index, k=10, buckets=pow2_buckets(64))
    queue = MicroBatchQueue(step, window_s=10.0, max_queue=8)
    t_ok = queue.submit(queries[:8])
    t_shed = queue.submit(queries[8:16])        # would exceed max_queue
    res = queue.take(t_shed)
    assert isinstance(res, SearchFailure)
    assert res.error_type == "QueueFull" and res.attempts == 0
    assert queue.shed == 1
    queue.flush()
    assert queue.take(t_ok)                     # real result


# ------------------------------------------------------ ResilientSearch
def test_resilient_search_retries_then_succeeds():
    calls = []

    def flaky(q):
        calls.append(1)
        if len(calls) < 3:
            raise TransientFault("not yet")
        return "ok"

    rs = ResilientSearch(flaky, retries=3, backoff_s=1e-4)
    assert rs(None) == "ok"
    assert len(calls) == 3 and rs.retries_used == 2 and rs.failures == 0


def test_resilient_search_exhaustion_raises_unavailable():
    def always(q):
        raise TransientFault("nope")

    rs = ResilientSearch(always, retries=2, backoff_s=1e-4)
    with pytest.raises(SearchUnavailable) as ei:
        rs(None)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.cause, TransientFault)
    assert rs.failures == 1


def test_resilient_search_permanent_fails_fast():
    calls = []

    def dead(q):
        calls.append(1)
        raise PermanentFault("shard gone")

    rs = ResilientSearch(dead, retries=5, backoff_s=1e-4)
    with pytest.raises(PermanentFault):
        rs(None)
    assert len(calls) == 1


def test_resilient_search_deadline_cuts_retries():
    def slow_fail(q):
        raise TransientFault("x")

    rs = ResilientSearch(slow_fail, retries=50, backoff_s=0.02,
                         deadline_s=0.05)
    with pytest.raises(SearchUnavailable):
        rs(None)
    assert rs.retries_used < 50


def test_resilient_search_delegates_attrs(served_index):
    inner = BucketedSearch(lambda q: served_index.search(q, 10),
                           pow2_buckets(8))
    rs = ResilientSearch(inner, retries=1)
    assert rs.max_batch == 8
    assert rs.buckets == inner.buckets


def test_fault_schedule_is_deterministic():
    def schedule(seed):
        inj = FaultInjector(seed=seed, transient_rate=0.3,
                            permanent_rate=0.05)
        out = []
        for _ in range(64):
            try:
                inj.perturb()
                out.append("ok")
            except PermanentFault:
                out.append("perm")
            except TransientFault:
                out.append("trans")
        return out

    a, b = schedule(7), schedule(7)
    assert a == b
    assert a != schedule(8)
    assert {"trans", "perm"} & set(a)


def test_fault_schedule_equals_the_references():
    """One numpy rng, one draw per call: the reference's schedule."""
    from repro.serve.faults import FaultInjector as JaxFaultInjector

    def schedule(cls):
        inj = cls(seed=3, transient_rate=0.2, permanent_rate=0.1,
                  fail_calls=(5,))
        out = []
        for _ in range(40):
            try:
                inj.perturb()
                out.append("ok")
            except Exception as e:            # either package's classes
                out.append(type(e).__name__)
        return out

    assert schedule(FaultInjector) == schedule(JaxFaultInjector)


def test_injected_faults_are_catchable_as_base():
    inj = FaultInjector(fail_calls=(0,))
    with pytest.raises(InjectedFault):
        inj.wrap(lambda: None)()


# ------------------------------------------------------------ launchers
def _run(*args, timeout=240):
    out = subprocess.run(
        [sys.executable, "-m", *args, "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


_FLOAT = r"(\d+\.\d+)"


def test_serve_cli_ann_bucketed_default():
    out = _run("repro_torch.launch.serve", "--arch", "ann-laion")
    m = re.search(r"ann-laion \[PCA32,NSG16,EP16\] bucketed \(window=0\.0s,"
                  r" buckets=\[1, 2, 4, 8, 16, 32, 64\]\): \d+ QPS, "
                  rf"recall@10={_FLOAT}, served shapes=\[[\d, ]+\] "
                  r"\(all pre-warmed\)", out)
    assert m, out
    assert float(m.group(1)) >= 0.50        # the reference's PCA floor
    assert re.search(r"latency p50=[\d.]+ms p99=[\d.]+ms mean=[\d.]+ms over "
                     r"128 queries / \d+ flushes, batch occupancy=[\d.]+",
                     out), out


def test_serve_cli_ann_unbucketed_snapshot_and_restore(tmp_path):
    snap = str(tmp_path / "snap")
    out = _run("repro_torch.launch.serve", "--arch", "ann-laion", "--spec",
               "IVF64,Flat", "--buckets", "off", "--snapshot", snap)
    m = re.search(rf"ann-laion \[IVF64,Flat\]: \d+ QPS, recall@10={_FLOAT}",
                  out)
    assert m and float(m.group(1)) > 0.85, out  # the reference's IVF floor
    assert f"snapshot saved to {snap}" in out
    again = _run("repro_torch.launch.serve", "--arch", "ann-laion",
                 "--buckets", "off", "--restore", snap)
    assert re.search(rf"restored \[IVF64,Flat\] from {re.escape(snap)} in "
                     r"[\d.]+s \(checksums verified, invariants validated\)",
                     again), again
    m2 = re.search(rf"ann-laion \[IVF64,Flat\]: \d+ QPS, recall@10={_FLOAT}",
                   again)
    assert m2 and m2.group(1) == m.group(1), again


def test_serve_cli_fault_injection_answers_every_ticket():
    out = _run("repro_torch.launch.serve", "--arch", "ann-laion", "--spec",
               "Flat", "--fault-rate", "0.3", "--retries", "3")
    assert re.search(r"faults: \d+ injected \(rate=0\.3, seed=0\), \d+ "
                     r"absorbed by retry", out), out
    m = re.search(rf"recall@10={_FLOAT}", out)
    assert m and float(m.group(1)) >= 0.999, out


def test_serve_cli_shards_still_raise(capsys):
    """--shards raised until the sharded tier was ported (ROADMAP Queue 1
    item 9); it serves now, and a bad --on-shard-error is still refused."""
    from repro_torch.launch.serve import main
    main(["--arch", "ann-laion", "--device", "cpu", "--shards", "2",
          "--spec", "Flat", "--on-shard-error", "skip"])
    out = capsys.readouterr().out
    m = re.search(rf"recall@10={_FLOAT}", out)
    assert m and float(m.group(1)) >= 0.999, out
    assert "degraded:" not in out
    with pytest.raises(SystemExit):
        main(["--arch", "ann-laion", "--device", "cpu", "--shards", "2",
              "--on-shard-error", "ignore"])


def test_tune_cli_spec_mode():
    out = _run("repro_torch.launch.tune", "--spec", "IVF64,Flat", "--n",
               "2000", "--dim", "32", "--trials", "6", "--mode", "single")
    assert "-- build log (6 evals) --" in out
    assert "0 structural builds, 0 reprune derivations, 6 pure cache hits" \
        in out
    best = re.search(r"\{'nprobe': (\d+)\}\s+" + _FLOAT, out)
    assert best and float(best.group(2)) >= 0.9, out
    assert "reprune grid" not in out
