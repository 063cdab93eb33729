"""Entry-point optimization (paper §3.1, knob k).

k-means over the database; each cluster's representative is the member
vector nearest the mean. At query time the traversal starts from the
representative of the query's nearest centroid.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.distances import nearest
from repro_torch.core.kmeans import kmeans


@dataclass(frozen=True)
class EntryPointSelector:
    centroids: torch.Tensor     # (k, D) cluster means
    member_ids: torch.Tensor    # (k,) int32 database ids of representatives

    def select(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, D) -> (Q,) int32 database entry ids."""
        _, c = nearest(queries, self.centroids)
        return self.member_ids[c.long()]


def fit_entry_points(generator: Optional[torch.Generator],
                     data: torch.Tensor, k: int,
                     iters: int = 10) -> EntryPointSelector:
    """k=1 degenerates to the global medoid (vanilla NSG's navigating
    node); k > N is clamped to N with a warning."""
    n = data.shape[0]
    if k > n:
        warnings.warn(
            f"ep_clusters={k} exceeds database size N={n}; clamping to {n}",
            RuntimeWarning, stacklevel=2)
        k = n
    if k == 1:
        mean = data.float().mean(0, keepdim=True)
        _, mid = nearest(mean, data)
        return EntryPointSelector(centroids=mean, member_ids=mid)
    km = kmeans(generator, data, k, iters=iters)
    _, member = nearest(km.centroids, data)
    return EntryPointSelector(centroids=km.centroids,
                              member_ids=member.to(torch.int32))
