"""Resilient serving: bounded retry around any search step + typed error
results for the micro-batch queue (the reference's
``serve/resilience.py``).

``ResilientSearch`` wraps a search callable (the raw step, a
``BucketedSearch``, or a fault-injected proxy) with the retry contract a
serve loop needs: bounded attempts, exponential backoff, a per-call
deadline, and a fatal-exception list that short-circuits retries for
errors that cannot succeed on retry (``PermanentFault`` by default —
retrying a dead shard just burns the latency budget). Attribute access
delegates to the wrapped callable, so ``MicroBatchQueue`` sees
``max_batch`` / ``dispatched`` / ``warmup`` through it unchanged.

``SearchFailure`` is the typed error *result*: when the hardened
``MicroBatchQueue.flush`` exhausts its retry, every pending ticket is
answered with one of these instead of being dropped — callers always get
an answer for every ticket (a result or a failure they can act on),
which is the zero-lost-tickets contract the fault-injection suite
asserts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

from repro_torch.serve.faults import PermanentFault


@dataclass(frozen=True)
class SearchFailure:
    """Typed per-ticket error result (stored where (dists, ids) would be).

    ``error`` is the final exception's message, ``error_type`` its class
    name, ``attempts`` how many tries the flush burned. Truthiness is
    False so ``result or fallback`` reads naturally in callers.
    """
    error: str
    error_type: str
    attempts: int = 1

    def __bool__(self) -> bool:
        return False


class SearchUnavailable(RuntimeError):
    """Raised when retries/deadline are exhausted; carries the last cause."""

    def __init__(self, message: str, attempts: int,
                 cause: Optional[BaseException] = None):
        super().__init__(message)
        self.attempts = attempts
        self.cause = cause


class ResilientSearch:
    """Bounded-retry wrapper: ``fn`` with up to ``retries`` re-attempts.

    * ``retries`` — re-attempts after the first try (total calls is
      ``retries + 1``);
    * ``backoff_s`` / ``backoff_mult`` — sleep before retry n is
      ``backoff_s * backoff_mult**(n-1)`` (exponential);
    * ``deadline_s`` — wall-clock budget across all attempts of one call;
      exceeded -> ``SearchUnavailable`` even with retries left (a serve
      flush must answer within its latency envelope or fail fast);
    * ``fatal`` — exception types never retried (default
      ``PermanentFault``): they re-raise immediately.

    Counters (``calls``/``retries_used``/``failures``) feed the serve
    loop's accounting.
    """

    def __init__(self, fn: Callable, retries: int = 2,
                 backoff_s: float = 0.001, backoff_mult: float = 2.0,
                 deadline_s: Optional[float] = None,
                 fatal: Tuple[Type[BaseException], ...] = (PermanentFault,)):
        self._fn = fn
        self.retries = retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.deadline_s = deadline_s
        self.fatal = fatal
        self.calls = 0
        self.retries_used = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        start = time.perf_counter()
        delay = self.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            if (self.deadline_s is not None and attempt > 0
                    and time.perf_counter() - start >= self.deadline_s):
                break
            try:
                return self._fn(*args, **kwargs)
            except self.fatal:
                self.failures += 1
                raise
            except Exception as e:
                last = e
                if attempt < self.retries:
                    self.retries_used += 1
                    time.sleep(delay)
                    delay *= self.backoff_mult
        self.failures += 1
        raise SearchUnavailable(
            f"search failed after {self.retries + 1} attempts "
            f"({time.perf_counter() - start:.3f}s): {last}",
            attempts=self.retries + 1, cause=last)

    def __getattr__(self, name):
        # delegate (max_batch, dispatched, warmup, search_stats, ...) so
        # wrapping is transparent to MicroBatchQueue and the serve loop
        return getattr(self._fn, name)
