"""Product quantization — paper Fig. 1 baseline ("...,PQ32": 32-byte
codes), the reference's ``core/pq.py``.

M sub-quantizers of 256 centroids each (``core.quant.PQCodec``); search is
asymmetric distance computation (ADC): a per-query (M, 256) LUT, then a
gather-sum over every code row. The reference's form gathers a (Q, N, M)
tensor; the port scans the N rows in chunks through ``kernels/lut_dist``
(ids = the chunk's rows, the sum left to right over M) and keeps a running
top-k across chunks, ties by lower id as ``lax.top_k``'s.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distances import smallest_k
from repro_torch.core.quant import PQCodec, pq_lut
from repro_torch.kernels.lut_dist import lut_dist

# (query, row) pairs per lut_dist launch of the ADC scan
SCAN_PAIRS = 1 << 24


class PQIndex:
    def __init__(self, m: int = 32, n_centroids: int = 256, device=None):
        self.codec = PQCodec(m, n_centroids)
        self.codes: Optional[torch.Tensor] = None     # (N, M) uint8
        self.device = resolve_device(device)
        self.spec: Optional[str] = None

    def fit(self, data, generator: Optional[torch.Generator] = None, *,
            init_centroids=None):
        """Train the codebooks (k-means++ seeds from ``generator``, or
        ``init_centroids`` (M, C, dsub) handed in) and encode ``data``."""
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        self.codec.fit(data, generator=generator,
                       init_centroids=init_centroids)
        self.codes = self.codec.encode(data).contiguous()
        return self

    @property
    def m(self) -> int:
        return self.codec.m

    @property
    def n_centroids(self) -> int:
        return self.codec.n_centroids

    @property
    def codebooks(self) -> Optional[torch.Tensor]:
        return self.codec.codebooks

    def search(self, queries, k: int, params=None):
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        return adc_scan(pq_lut(q, self.codebooks).contiguous(), self.codes,
                        k)

    @property
    def ntotal(self) -> int:
        return 0 if self.codes is None else self.codes.shape[0]

    @property
    def dim(self) -> int:
        if self.codebooks is None:
            return 0
        return self.codebooks.shape[0] * self.codebooks.shape[2]

    def search_params_space(self):
        from repro_torch.core.index_api import empty_space
        return empty_space()    # ADC scan is exhaustive; no runtime knob

    def memory_bytes(self) -> int:
        return int(self.codes.numel() * 1 + self.codebooks.numel() * 4)

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        return {"meta": {"m": self.m, "n_centroids": self.n_centroids},
                "arrays": {"codebooks": self.codebooks.cpu().numpy(),
                           "codes": self.codes.cpu().numpy()}}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "PQIndex":
        meta, a = state["meta"], state["arrays"]
        idx = cls(m=meta["m"], n_centroids=meta["n_centroids"],
                  device=device)
        t = lambda name: torch.from_numpy(np.array(a[name])).to(idx.device)
        idx.codec.codebooks = t("codebooks").float()
        idx.codes = t("codes").to(torch.uint8).contiguous()
        return idx


def adc_scan(lut: torch.Tensor, codes: torch.Tensor, k: int):
    """(Q, M, C) LUT over all (N, M) uint8 code rows -> the k smallest ADC
    distances per query and their row ids, ties by lower id: chunks of rows
    through ``lut_dist``, each merged with the running top-k (the running
    entries hold lower ids than the chunk's, so the merge keeps the rule)."""
    qn, n = lut.shape[0], codes.shape[0]
    step = max(1, min(n, SCAN_PAIRS // max(qn, 1)))
    best_d = torch.empty((qn, 0), dtype=torch.float32, device=lut.device)
    best_i = torch.empty((qn, 0), dtype=torch.int32, device=lut.device)
    for s in range(0, n, step):
        ids = torch.arange(s, min(s + step, n), dtype=torch.int32,
                           device=lut.device).expand(qn, -1).contiguous()
        d = torch.cat([best_d, lut_dist(lut, codes, ids)], dim=1)
        i = torch.cat([best_i, ids], dim=1)
        best_d, pos = smallest_k(d, k)
        best_i = i.gather(1, pos.long())
    return best_d, best_i
