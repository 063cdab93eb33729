"""IVF-PQ — paper Fig. 1's "IVF512,PQ32" family, the reference's
``core/ivfpq.py``: coarse inverted lists with PQ-compressed residual codes
and ADC scoring inside the probed lists.

The search builds each (query, probed list) pair's residual LUT, (Q*P, M,
C), and scores the lists' codes through ``kernels/lut_dist``: the codes
are one (n_lists*cap, M) uint8 table and a pair's ids are ``list*cap +
slot`` (-1 for pads), so a pair reads its own LUT. ``list_codes`` is kept
as the reference's int32 (L, cap, M) table (what a snapshot holds); the
uint8 table is derived from it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distances import l2_topk, smallest_k
from repro_torch.core.index_api import param_or
from repro_torch.core.ivf import posting_lists, query_chunk
from repro_torch.core.kmeans import kmeans
from repro_torch.core.pq import PQIndex
from repro_torch.core.quant import pq_lut
from repro_torch.kernels.lut_dist import lut_dist


class IVFPQIndex:
    def __init__(self, n_lists: int = 256, m: int = 16, nprobe: int = 8,
                 device=None):
        self.n_lists = n_lists
        self.m = m
        self.nprobe = nprobe
        self.device = resolve_device(device)
        self.centroids: Optional[torch.Tensor] = None
        self.lists: Optional[torch.Tensor] = None       # (L, cap) ids
        self.list_codes: Optional[torch.Tensor] = None  # (L, cap, M) int32
        self.pq: Optional[PQIndex] = None
        self._flat_codes: Optional[torch.Tensor] = None  # (L*cap, M) uint8
        self._shape = (0, 0)                             # (N, D) set by fit
        self.spec: Optional[str] = None

    def fit(self, data, generator: Optional[torch.Generator] = None, *,
            iters: int = 8, init_centroids=None, pq_init_centroids=None):
        """k-means (``iters`` Lloyd steps), then PQ on the residuals (the
        classic IVFADC). Both k-means++ seedings draw from ``generator``
        (default a CPU generator seeded with 0), unless ``init_centroids``
        / ``pq_init_centroids`` hand them in."""
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device)
        n, d = data.shape
        self._shape = (n, d)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        km = kmeans(generator, data, self.n_lists, iters=iters,
                    init_centroids=init_centroids)
        self.centroids = km.centroids
        residual = data - km.centroids[km.assignments.long()]
        self.pq = PQIndex(m=self.m, device=self.device).fit(
            residual, generator=generator, init_centroids=pq_init_centroids)
        self.lists, order, slot = posting_lists(km.assignments,
                                                self.n_lists)
        codes = torch.zeros((self.n_lists, self.lists.shape[1], self.m),
                            dtype=torch.int32, device=self.device)
        codes[km.assignments.long()[order], slot] = \
            self.pq.codes[order].to(torch.int32)
        self.list_codes = codes
        self._device_tables()
        return self

    def _device_tables(self):
        self._flat_codes = self.list_codes.reshape(-1, self.m).to(
            torch.uint8).contiguous()

    def search(self, queries, k: int, params=None):
        nprobe = min(param_or(params, "nprobe", self.nprobe), self.n_lists)
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device).contiguous()
        _, probe = l2_topk(q, self.centroids, nprobe)       # (Q, P)
        probe = probe.long()
        cap = self.lists.shape[1]
        slots = torch.arange(cap, device=self.device)
        step = query_chunk(q.shape[0], nprobe * cap)
        out_d, out_i = [], []
        for s in range(0, q.shape[0], step):
            pr = probe[s:s + step]
            qn = pr.shape[0]
            cand = self.lists[pr]                           # (q, P, cap)
            # residual LUT per probed centroid: r = q - centroid
            res = q[s:s + step, None, :] - self.centroids[pr]
            lut = pq_lut(res.reshape(qn * nprobe, -1),
                         self.pq.codebooks).contiguous()     # (q*P, M, C)
            ids = torch.where(cand >= 0, pr[..., None] * cap + slots, -1)
            d = lut_dist(lut, self._flat_codes,
                         ids.reshape(qn * nprobe, cap)).reshape(qn, -1)
            dk, pos = smallest_k(d, k)
            out_d.append(dk)
            out_i.append(cand.reshape(qn, -1).gather(1, pos.long()))
        return torch.cat(out_d), torch.cat(out_i)

    @property
    def ntotal(self) -> int:
        return 0 if self.lists is None else self._shape[0]

    @property
    def dim(self) -> int:
        return 0 if self.lists is None else self._shape[1]

    def search_params_space(self):
        from repro_torch.core.index_api import nprobe_space
        return nprobe_space(self.n_lists)

    def memory_bytes(self) -> int:
        return int(self.lists.numel() * 4 + self.list_codes.numel()
                   + self.pq.codebooks.numel() * 4
                   + self.centroids.numel() * 4)

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        sub = self.pq.state_dict()
        arrays = {"centroids": self.centroids.cpu().numpy(),
                  "lists": self.lists.cpu().numpy(),
                  "list_codes": self.list_codes.cpu().numpy()}
        arrays.update({f"pq/{k}": v for k, v in sub["arrays"].items()})
        return {"meta": {"n_lists": self.n_lists, "m": self.m,
                         "nprobe": self.nprobe,
                         "shape": [int(v) for v in self._shape],
                         "pq": sub["meta"]},
                "arrays": arrays}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "IVFPQIndex":
        meta, a = state["meta"], state["arrays"]
        idx = cls(n_lists=meta["n_lists"], m=meta["m"],
                  nprobe=meta["nprobe"], device=device)
        idx._shape = tuple(meta["shape"])
        t = lambda name: torch.from_numpy(np.array(a[name])).to(idx.device)
        idx.centroids = t("centroids").float()
        idx.lists = t("lists").to(torch.int32).contiguous()
        idx.list_codes = t("list_codes").to(torch.int32)
        idx.pq = PQIndex.from_state({
            "meta": meta["pq"],
            "arrays": {k[len("pq/"):]: v for k, v in a.items()
                       if k.startswith("pq/")}}, device=idx.device)
        idx._device_tables()
        return idx
