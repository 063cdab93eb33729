"""Power-of-two batch buckets (the reference's ``serve/batching.py``, its
bucket helpers).

The compacted search (``core/beam_search.beam_search_compacted``)
shrinks its batch into these sizes between slices. ``BucketedSearch`` and
``MicroBatchQueue`` are not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Sequence, Tuple


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
