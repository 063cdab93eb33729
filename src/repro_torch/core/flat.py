"""Brute-force (FlatL2) index — the paper's baseline and the recall oracle
(the reference's ``core/flat.py``; a ``core.index_api.Index``).

``search`` is one ``l2_topk`` pass over the raw vectors: on the card the
``l2topk`` kernel, on the CPU its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distances import l2_topk


@dataclass
class FlatIndex:
    """Exact index. ``FlatIndex(data)`` and ``FlatIndex().fit(data)`` are
    equivalent; searches run on the device that holds ``data``."""
    data: Optional[torch.Tensor] = None

    def fit(self, data: torch.Tensor,
            generator: Optional[torch.Generator] = None):
        """Keep the vectors (exact search needs nothing else);
        ``generator`` is accepted for the ``Index`` protocol and unused, as
        the reference's ``fit`` ignores its key."""
        del generator
        self.data = data
        return self

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def ntotal(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def dim(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    def search(self, queries, k: int, params=None, *,
               chunk: Optional[int] = None):
        """Exact (dists, ids); the oracle every other index is scored
        against. An explicit ``chunk=`` wins over ``params.chunk``."""
        if chunk is None and params is not None:
            chunk = params.chunk
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            self.data.device)
        return l2_topk(q, self.data, k, chunk=chunk or 16384)

    def search_params_space(self):
        # exact search always has recall 1.0; chunk is its one (QPS-only)
        # runtime knob
        from repro_torch.core.tuning.space import Int, SearchSpace
        return SearchSpace().add("chunk", Int(1024, 65536, log=True))

    def memory_bytes(self) -> int:
        return int(self.data.numel() * self.data.element_size())

    # -- persistence ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"meta": {}, "arrays": {"data": self.data.cpu().numpy()}}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "FlatIndex":
        dev = resolve_device(device)
        return cls(torch.from_numpy(
            np.array(state["arrays"]["data"])).to(dev))


def recall_at_k(pred_ids, true_ids) -> float:
    """Paper's Recall@k = |R ∩ R_hat| / k, averaged over queries.

    k is the number of *requested* neighbors (pred columns); only the
    oracle's first k columns count as R. Ids < 0 (padding) never hit.
    """
    pred = torch.as_tensor(pred_ids)
    true = torch.as_tensor(true_ids).to(pred.device)
    k = pred.shape[1]
    hits = (pred[:, :, None] == true[:, None, :k]).any(-1)
    valid = pred >= 0
    return float(((hits & valid).sum(1).float() / k).mean())
