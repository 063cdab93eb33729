"""Deterministic fault injection — the test substrate for resilient serving
(the reference's ``serve/faults.py``).

Every failure mode the serve path must survive is producible on demand and
*reproducibly* (seeded ``np.random.default_rng``; same seed, same call
sequence, same faults — a flaky resilience test is worse than none):

  * ``FaultInjector.wrap(fn)`` — a callable proxy around any search step
    that raises ``TransientFault`` / ``PermanentFault`` or sleeps a
    latency spike on scheduled calls, passing everything else through
    untouched (``__getattr__`` delegates, so a wrapped ``BucketedSearch``
    still exposes ``max_batch`` / ``dispatched`` / ``warmup``);
  * ``FaultInjector.wrap_index(index)`` — the same proxy at the ``Index``
    granularity (fit/search delegate; ``search`` faults), for killing one
    shard of a ``ShardedFactoryIndex``;
  * ``corrupt_payload(dir)`` — deterministic byte-flips inside a committed
    snapshot's ``arrays.npz``, the input for checksum-detection tests.

The exception taxonomy mirrors what retry logic needs to distinguish:
``TransientFault`` (retry may succeed — a timeout, a preempted device)
vs ``PermanentFault`` (retry is pointless — a dead shard, poisoned
state). Both derive from ``InjectedFault`` so tests can assert "no
injected fault ever escaped uncaught".
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Base of every injector-raised error (assert none escape)."""


class TransientFault(InjectedFault):
    """Fails now, may succeed on retry (timeout / preemption flavor)."""


class PermanentFault(InjectedFault):
    """Fails deterministically forever (dead-shard flavor)."""


class FaultInjector:
    """Seeded schedule of faults over a call sequence.

    ``transient_rate`` / ``permanent_rate`` / ``latency_rate`` are
    per-call probabilities drawn from the injector's own rng (one draw
    per call, so the fault schedule depends only on seed + call index).
    ``fail_calls`` additionally forces a ``TransientFault`` on those
    exact 0-based call indexes — the precise tool for "flush #2 fails
    once, then succeeds" regression tests.
    """

    def __init__(self, seed: int = 0, transient_rate: float = 0.0,
                 permanent_rate: float = 0.0, latency_rate: float = 0.0,
                 latency_s: float = 0.01,
                 fail_calls: Iterable[int] = ()):
        self.rng = np.random.default_rng(seed)
        self.transient_rate = transient_rate
        self.permanent_rate = permanent_rate
        self.latency_rate = latency_rate
        self.latency_s = latency_s
        self.fail_calls = frozenset(int(c) for c in fail_calls)
        self.calls = 0
        self.faults_raised = 0
        self.spikes_injected = 0

    def perturb(self) -> None:
        """One scheduled decision: raise, sleep, or do nothing."""
        call = self.calls
        self.calls += 1
        draw = float(self.rng.uniform())
        if call in self.fail_calls:
            self.faults_raised += 1
            raise TransientFault(f"injected transient fault (call {call})")
        if draw < self.permanent_rate:
            self.faults_raised += 1
            raise PermanentFault(f"injected permanent fault (call {call})")
        if draw < self.permanent_rate + self.transient_rate:
            self.faults_raised += 1
            raise TransientFault(f"injected transient fault (call {call})")
        if draw < (self.permanent_rate + self.transient_rate
                   + self.latency_rate):
            self.spikes_injected += 1
            time.sleep(self.latency_s)

    def wrap(self, fn: Callable) -> "FaultyCallable":
        return FaultyCallable(fn, self)

    def wrap_index(self, index) -> "FaultyIndex":
        return FaultyIndex(index, self)


class FaultyCallable:
    """``fn`` with the injector's schedule applied before every call."""

    def __init__(self, fn: Callable, injector: FaultInjector):
        self._fn = fn
        self.injector = injector

    def __call__(self, *args, **kwargs):
        self.injector.perturb()
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        # delegate so BucketedSearch attrs (max_batch, dispatched, warmup,
        # search_stats) survive wrapping
        return getattr(self._fn, name)


class FaultyIndex:
    """Index proxy whose ``search`` is on the injector's schedule.

    Everything else (fit, ntotal, state_dict, ...) delegates to the
    wrapped index, so it stands in for an index wherever one is served.
    """

    def __init__(self, index, injector: FaultInjector):
        self._index = index
        self.injector = injector

    def search(self, queries, k, params=None, **kw):
        self.injector.perturb()
        return self._index.search(queries, k, params, **kw)

    def __getattr__(self, name):
        return getattr(self._index, name)


def corrupt_file(path: str, seed: int = 0, n_bytes: int = 8) -> None:
    """Flip ``n_bytes`` bytes of ``path`` at seeded positions, in place."""
    rng = np.random.default_rng(seed)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        for pos in rng.integers(0, size, size=min(n_bytes, size)):
            f.seek(int(pos))
            b = f.read(1)
            f.seek(int(pos))
            f.write(bytes([b[0] ^ 0xFF]))


def corrupt_payload(payload_dir: str, seed: int = 0,
                    n_bytes: int = 8) -> None:
    """Corrupt a committed payload's array bytes (manifest left intact, so
    the damage is exactly what the per-array checksums must catch)."""
    corrupt_file(os.path.join(payload_dir, "arrays.npz"), seed=seed,
                 n_bytes=n_bytes)
