"""k-means (k-means++ init + Lloyd) for entry-point clustering (paper
§3.1, knob k).

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
    proportional to its squared distance to the nearest chosen one."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=generator))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind = pairwise_sqdist(x[first][None, :], x)[0]          # (N,)
    for i in range(1, k):
        p = (mind / mind.sum().clamp_min(1e-12)).double().cpu()
        nxt = int(torch.multinomial(p, 1, generator=generator))
        cents[i] = x[nxt]
        mind = torch.minimum(mind, pairwise_sqdist(x[nxt][None, :], x)[0])
    return cents


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
