"""AntiHub removal (paper §3.1, knob alpha) — Tanaka et al., ICMR'21.

The k-occurrence N_k(x) counts how many points list x among their k
nearest neighbors. Dropping the lowest-N_k (1 - alpha) fraction shrinks
the database with little recall loss. Counts are integers
(``torch.bincount``), so they are exact on every device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.build import build_knn


def k_occurrence(data: torch.Tensor, k: int = 10, *,
                 knn_ids: Optional[torch.Tensor] = None,
                 backend: str = "exact") -> torch.Tensor:
    """(N,) int32 hub scores N_k(x) from the kNN graph (``knn_ids``
    (N, >=k) skips the graph build; its first k columns are counted)."""
    if knn_ids is None:
        _, knn_ids = build_knn(data, k, backend=backend)
    if knn_ids.shape[1] < k:
        raise ValueError(
            f"knn_ids has {knn_ids.shape[1]} columns, need k={k}")
    ids = knn_ids[:, :k].reshape(-1)
    ids = ids[ids >= 0].long()
    return torch.bincount(ids, minlength=data.shape[0]).to(torch.int32)


def antihub_keep_indices(data: torch.Tensor, keep_ratio: float, k: int = 10,
                         *, knn_ids: Optional[torch.Tensor] = None,
                         backend: str = "exact") -> torch.Tensor:
    """Sorted indices of the ceil(alpha*N) hubbiest points to KEEP."""
    if not 0.0 < keep_ratio <= 1.0:
        raise ValueError(f"keep_ratio must be in (0, 1], got {keep_ratio}")
    n = data.shape[0]
    n_keep = max(1, math.ceil(keep_ratio * n))
    if n_keep >= n:
        return torch.arange(n, dtype=torch.int32, device=data.device)
    occ = k_occurrence(data, k, knn_ids=knn_ids, backend=backend)
    # stable ordering: high occurrence first, ties by index
    order = torch.sort(-occ, stable=True).indices
    return torch.sort(order[:n_keep]).values.to(torch.int32)
