"""Out-of-core build substrate: fixed-size chunk streaming + host offload
(the reference's ``core/build/stream.py``).

  * **chunk spans** — every O(N * R) pass in the build is row-independent,
    so it streams over ``chunk_spans(n, chunk)`` and never materializes
    the per-structure ``(N, R)`` f32 distance table. ``ANN_BUILD_CHUNK``
    overrides the default chunk (2048), the knob that bounds device temp
    memory for builds larger than the card.

  * **``HostOffloadStore``** — keyed trees of tensors parked in host
    memory with one-deep prefetch, so one card builds and serves shard
    sets larger than its memory: only the active shard and the prefetched
    next one are on the card. On CUDA the host buffers are pinned
    (allocated pinned, then copied into), ``prefetch`` issues the
    host-to-device copies ``non_blocking`` on a side stream and records an
    event, and ``fetch`` makes the current stream wait on that event and
    marks the tensors used on it (``record_stream``) so the caching
    allocator does not hand their memory out while the current stream
    still reads them. On the CPU the store keeps plain tensors and
    ``prefetch`` only stages.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device

DEFAULT_CHUNK = int(os.environ.get("ANN_BUILD_CHUNK", 2048))


def chunk_spans(n: int, chunk: Optional[int] = None
                ) -> Iterator[Tuple[int, int]]:
    """Fixed-size (start, end) row spans covering [0, n)."""
    chunk = chunk or DEFAULT_CHUNK
    for s in range(0, n, chunk):
        yield s, min(s + chunk, n)


def tree_map(fn: Callable, tree):
    """``fn`` over the tensor leaves of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostOffloadStore:
    """Keyed host-resident tensor trees with one-deep device prefetch.

    ``offload(key, tree)`` copies every leaf to a host buffer and returns
    once the copies are done (the caller then drops its device references:
    that is what frees device memory); ``prefetch(key)`` stages the
    transfer of a whole tree to ``device``; ``fetch(key)`` returns the
    device tree, consuming the staged copy if one exists. Staging is one
    deep per key: prefetching ``i + 1`` while computing on ``i`` bounds
    device residency at two chunks. ``device`` defaults to the card.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._host: Dict[Any, Any] = {}
        self._staged: Dict[Any, Any] = {}     # key -> (tree, event)
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def pinned(self) -> bool:
        return self.device.type == "cuda"

    def __contains__(self, key) -> bool:
        return key in self._host

    def keys(self):
        return self._host.keys()

    def _to_host(self, x) -> torch.Tensor:
        """One leaf -> a host buffer (pinned on CUDA). A leaf that already
        is one is kept as is, so re-offloading a host tree shares it."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        if x.device.type == "cpu" and (not self.pinned or x.is_pinned()):
            return x
        if not self.pinned:
            return x.cpu()
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)                # blocking: done when this returns
        return buf

    def offload(self, key, tree) -> None:
        """Copy a tree of tensors to host buffers under ``key``."""
        self._host[key] = tree_map(self._to_host, tree)
        self._staged.pop(key, None)     # stale device copy, if any

    def prefetch(self, key) -> None:
        """Start the device transfer of ``key``'s tree (no-op when unknown
        or already staged)."""
        if key not in self._host or key in self._staged:
            return
        host = self._host[key]
        if not self.pinned:
            self._staged[key] = (tree_map(lambda t: t.to(self.device),
                                          host), None)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            tree = tree_map(lambda t: t.to(self.device, non_blocking=True),
                            host)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._staged[key] = (tree, done)

    def fetch(self, key):
        """Device-resident tree for ``key`` (consumes the staged copy)."""
        staged = self._staged.pop(key, None)
        if staged is None:
            return tree_map(lambda t: t.to(self.device), self._host[key])
        tree, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in tree_leaves(tree):
                t.record_stream(cur)
        return tree

    def peek_host(self, key):
        """The host tree itself (the very tensors the store holds)."""
        return self._host[key]

    def drop(self, key) -> None:
        self._host.pop(key, None)
        self._staged.pop(key, None)

    def nbytes(self) -> int:
        return sum(_nbytes(leaf) for tree in self._host.values()
                   for leaf in tree_leaves(tree))
