"""Bucketed micro-batching for the ANN serve path (the reference's
``serve/batching.py``).

Serving traffic arrives as ragged request batches (1 query here, 17
there). The reference keeps its jit cache hot by padding each batch to one
of a few shapes; the port keeps the same contract, so the set of shapes a
serve loop sends to the device stays the warmed set:

  * ``pow2_buckets`` — the allowed batch shapes (powers of two up to the
    configured maximum); the compacted search
    (``core/beam_search.beam_search_compacted``) also shrinks its batch
    into these sizes between slices;
  * ``BucketedSearch`` — pads every request batch up to its bucket, runs
    the underlying search step, slices the padding back off;
  * ``MicroBatchQueue`` — accumulates requests for up to ``window_s``
    seconds (or until the largest bucket fills), then serves them as one
    padded batch and scatters results back per ticket.

Results are exactly those of the unbatched search: padding rows are sliced
off before anything is returned, and a query's traversal is independent of
its batch neighbors. Answers come back to the host (numpy) before a
latency sample is taken, so each sample waits for the device.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def pow2_buckets(max_batch: int, min_bucket: int = 1) -> Tuple[int, ...]:
    """Power-of-two bucket sizes covering [1, max_batch]."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = max(1, min_bucket)
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(b)            # first power of two >= max_batch
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` queries."""
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {max(buckets)}")


def _host(q) -> np.ndarray:
    return q.detach().cpu().numpy() if isinstance(q, torch.Tensor) \
        else np.asarray(q)


class BucketedSearch:
    """Pad request batches to fixed bucket shapes around any search step.

    ``search_fn(queries) -> (dists, ids)`` is the wrapped step (e.g. the
    closure from ``serve_step.ann_search_step``). Padding queries are copies
    of the batch's first row — always in-distribution, sliced off on return.
    ``dispatched`` records the padded batch size of every underlying call,
    so tests can check the shape set stays equal to the warmed bucket set.
    """

    def __init__(self, search_fn: Callable, buckets: Sequence[int]):
        if not buckets:
            raise ValueError("need at least one bucket")
        self.search_fn = search_fn
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.dispatched: List[int] = []

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def warmup(self, dim: int, dtype=torch.float32) -> None:
        """One call per bucket shape up front (server start, not first
        hit), each waited for; the step moves the zero batch to its
        index's device."""
        for b in self.buckets:
            _, i = self.search_fn(torch.zeros((b, dim), dtype=dtype))
            _host(i)
            self.dispatched.append(b)

    def __call__(self, queries):
        queries = torch.as_tensor(queries)
        n = queries.shape[0]
        if n > self.max_batch:          # oversized: serve in max-bucket runs
            parts = [self(queries[s:s + self.max_batch])
                     for s in range(0, n, self.max_batch)]
            return (torch.cat([d for d, _ in parts]),
                    torch.cat([i for _, i in parts]))
        b = bucket_for(n, self.buckets)
        if n < b:
            pad = queries[:1].expand((b - n,) + tuple(queries.shape[1:]))
            padded = torch.cat([queries, pad], dim=0)
        else:
            padded = queries
        self.dispatched.append(b)
        d, i = self.search_fn(padded)
        return d[:n], i[:n]


class MicroBatchQueue:
    """Accumulate requests, serve them as one bucketed batch per flush.

    Synchronous single-owner queue: ``submit`` returns a ticket, ``flush``
    answers every pending ticket, ``take(ticket)`` pops the answer (popping
    keeps ``results`` bounded on a long-running server). ``maybe_flush``
    flushes when the batching window has elapsed or the largest bucket is
    full — the latency/throughput trade the window knob controls.

    Zero-lost-tickets contract: EVERY submitted ticket is answered — with
    (dists, ids) numpy arrays on success, or with a typed
    ``serve.resilience.SearchFailure`` when the flush's search fails
    (retried ``flush_retries`` times, then failed) or the queue sheds under
    ``max_queue`` backpressure. The pending list is cleared before the
    search runs, so an exception can never strand tickets.

    Per-query latency (submit -> the answer on the host, one sample per
    served query) and batch occupancy (real rows / dispatched padded rows
    per flush) are recorded as they happen; ``latency_stats()`` reduces
    them to p50/p99/mean plus the failure accounting (``errors`` tickets
    failed, ``retries`` flush re-attempts, ``shed`` tickets rejected).
    """

    def __init__(self, search: BucketedSearch, window_s: float = 0.002,
                 flush_retries: int = 1,
                 max_queue: Optional[int] = None):
        self.search = search
        self.window_s = window_s
        self.flush_retries = flush_retries
        self.max_queue = max_queue       # pending-row cap; None = unbounded
        self._pending: List[Tuple[int, np.ndarray, float]] = []
        self._pending_rows = 0
        self._oldest: Optional[float] = None
        self._next_ticket = 0
        self.results: Dict[int, object] = {}
        self._latency_s: List[float] = []     # one sample per served query
        self._occupancy: List[float] = []     # rows / padded rows per flush
        self.flushes = 0
        self.errors = 0                  # tickets answered with a failure
        self.retries = 0                 # flush search re-attempts
        self.shed = 0                    # tickets rejected at submit

    def submit(self, queries) -> int:
        """Enqueue a (n, D) request; returns a ticket for ``results``.

        Under ``max_queue`` backpressure (pending rows would exceed it
        even after a flush) the ticket is answered IMMEDIATELY with a
        ``SearchFailure(error_type="QueueFull")`` — shed, not lost.
        """
        from repro_torch.serve.resilience import SearchFailure
        q = np.atleast_2d(_host(queries))
        if self._pending_rows + q.shape[0] > self.search.max_batch:
            self.flush()
        ticket = self._next_ticket
        self._next_ticket += 1
        if (self.max_queue is not None
                and self._pending_rows + q.shape[0] > self.max_queue):
            self.shed += 1
            self.results[ticket] = SearchFailure(
                error=f"queue full ({self._pending_rows} rows pending, "
                      f"max_queue={self.max_queue})",
                error_type="QueueFull", attempts=0)
            return ticket
        self._pending.append((ticket, q, time.perf_counter()))
        self._pending_rows += q.shape[0]
        if self._oldest is None:
            self._oldest = time.perf_counter()
        return ticket

    def take(self, ticket: int):
        """Pop a flushed ticket's answer — (dists, ids) or a
        ``SearchFailure`` — once, keeping memory flat."""
        return self.results.pop(ticket)

    def maybe_flush(self) -> bool:
        """Flush if the window elapsed or the largest bucket is full."""
        if not self._pending:
            return False
        full = self._pending_rows >= self.search.max_batch
        due = (time.perf_counter() - self._oldest) >= self.window_s
        if full or due:
            self.flush()
            return True
        return False

    def flush(self) -> None:
        from repro_torch.serve.resilience import SearchFailure
        if not self._pending:
            return
        # clear queue state FIRST: whatever happens below, these tickets
        # are this flush's to answer and the queue is ready for new work
        pending, self._pending = self._pending, []
        self._pending_rows = 0
        self._oldest = None
        batch = torch.from_numpy(np.concatenate([q for _, q, _ in pending],
                                                axis=0))
        n_disp = len(getattr(self.search, "dispatched", ()))
        err: Optional[BaseException] = None
        attempts = 0
        for attempt in range(self.flush_retries + 1):
            attempts = attempt + 1
            try:
                d, i = self.search(batch)
                d, i = _host(d), _host(i)     # waits for the device
                err = None
                break
            except Exception as e:
                err = e
                if attempt < self.flush_retries:
                    self.retries += 1
        done = time.perf_counter()
        self.flushes += 1
        if err is not None:
            # answer every ticket with the typed failure — none lost
            failure = SearchFailure(error=str(err),
                                    error_type=type(err).__name__,
                                    attempts=attempts)
            for ticket, _, _ in pending:
                self.results[ticket] = failure
                self.errors += 1
            return
        padded = sum(getattr(self.search, "dispatched", ())[n_disp:])
        if padded:
            self._occupancy.append(batch.shape[0] / padded)
        row = 0
        for ticket, q, submitted in pending:
            n = q.shape[0]
            self.results[ticket] = (d[row:row + n], i[row:row + n])
            self._latency_s.extend([done - submitted] * n)
            row += n

    def latency_stats(self) -> dict:
        """Serving distribution so far: per-query latency percentiles (ms),
        mean batch occupancy (1.0 = every dispatched row was a real query),
        and failure accounting (errors / retries / shed)."""
        lat = np.asarray(self._latency_s, np.float64) * 1e3
        return {
            "served": int(lat.size),
            "flushes": self.flushes,
            "p50_ms": float(np.percentile(lat, 50)) if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) if lat.size else 0.0,
            "mean_ms": float(lat.mean()) if lat.size else 0.0,
            "mean_occupancy": float(np.mean(self._occupancy))
            if self._occupancy else 0.0,
            "errors": self.errors,
            "retries": self.retries,
            "shed": self.shed,
        }
