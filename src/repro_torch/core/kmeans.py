"""k-means (k-means++ init + Lloyd) for entry-point clustering (paper
§3.1, knob k) and PQ codebook training.

Random draws come from a ``torch.Generator`` on the CPU, so one seed gives
one init whatever device holds the data. ``init_centroids`` skips the
draws (a test hands in the reference's init). Cluster sums are a one-hot
matmul rather than ``index_add_``, whose float atomics on CUDA would move
the centroids from run to run.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.distances import l2_topk, pairwise_sqdist


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # (k, D)
    assignments: torch.Tensor   # (N,) int32
    inertia: torch.Tensor       # scalar, mean squared distance


def kmeanspp_init(generator: torch.Generator, x: torch.Tensor,
                  k: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn with probability
    proportional to its squared distance to the nearest chosen one.

    x (N, D) -> (k, D); a batch (B, N, D) -> (B, k, D) runs B independent
    seedings at once (PQ seeds all its sub-spaces in one run). A run's
    draws — the first index and k - 1 uniforms per batch member — come from
    the CPU ``generator`` in one go; each next centroid is then picked on
    x's device by inverse CDF (a float64 cumsum of the distances, then
    ``searchsorted``), so no step waits on the host.
    """
    batched = x.dim() == 3
    xb = x if batched else x[None]
    b, n, _ = xb.shape
    dev = x.device
    first = torch.randint(0, n, (b,), generator=generator).to(dev)
    u = torch.rand((b, max(k - 1, 0)), generator=generator,
                   dtype=torch.float64).to(dev)
    rows = torch.arange(b, device=dev)
    cents = torch.zeros((b, k, xb.shape[2]), dtype=x.dtype, device=dev)
    cents[:, 0] = xb[rows, first]
    mind = pairwise_sqdist(cents[:, :1], xb)[:, 0]             # (B, N)
    for i in range(1, k):
        cdf = torch.cumsum(mind.double(), dim=1)
        # first point whose cumulative mass exceeds u * total: a point at
        # distance 0 (already chosen) is never picked while mass remains
        nxt = torch.searchsorted(cdf, u[:, i - 1:i] * cdf[:, -1:],
                                 right=True)[:, 0].clamp_max(n - 1)
        cents[:, i] = xb[rows, nxt]
        mind = torch.minimum(mind,
                             pairwise_sqdist(cents[:, i:i + 1], xb)[:, 0])
    return cents if batched else cents[0]


def kmeans(generator: Optional[torch.Generator], x: torch.Tensor, k: int,
           iters: int = 10, chunk: int = 16384,
           init_centroids: Optional[torch.Tensor] = None) -> KMeansResult:
    n = x.shape[0]
    if k < 1 or k > n:
        raise ValueError(f"k={k} out of range for n={n}")
    if init_centroids is not None:
        cents = torch.as_tensor(init_centroids, dtype=x.dtype,
                                device=x.device).clone()
    else:
        if generator is None:
            raise ValueError("kmeans needs a generator or init_centroids")
        cents = kmeanspp_init(generator, x, k)
    for _ in range(iters):
        _, assign = l2_topk(x, cents, 1, chunk=chunk)
        onehot = torch.nn.functional.one_hot(assign[:, 0].long(), k).to(
            x.dtype)                                              # (N, k)
        sums = onehot.T @ x
        cnts = onehot.sum(0)
        new = sums / cnts.clamp_min(1.0)[:, None]
        # keep empty clusters where they were
        cents = torch.where((cnts > 0)[:, None], new, cents)
    dists, assign = l2_topk(x, cents, 1, chunk=chunk)
    return KMeansResult(cents, assign[:, 0], dists[:, 0].mean())
