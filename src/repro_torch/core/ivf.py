"""IVF (inverted file) index — paper Fig. 1 baseline ("IVF512,Flat"), the
reference's ``core/ivf.py``.

k-means coarse quantizer -> per-centroid posting lists; search probes the
``nprobe`` nearest lists. Lists are one padded (n_lists, cap) id table,
each list's ids ascending. A search sends the probed lists' ids (-1 pads)
through ``kernels/gather_dist`` — the diff-square arithmetic of the
reference's candidate distances — in query chunks, so the (Q, nprobe*cap,
D) row tensor of the reference's form never exists.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.distances import l2_topk, smallest_k
from repro_torch.core.index_api import param_or
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels.gather_dist import gather_dist

# candidate (query, id) pairs per search chunk: bounds the id and distance
# tables of one chunk (two 128 MB tables at 2^25)
CHUNK_PAIRS = 1 << 25


def posting_lists(assign: torch.Tensor, n_lists: int):
    """(N,) list of each row -> (lists (n_lists, cap) int32, -1 padded,
    each list's ids ascending; order (N,): the rows sorted by list, stable;
    slot (N,): each sorted row's slot in its list). The reference fills
    the table row by row in id order; a stable sort by list puts every
    row in the same slot."""
    n = assign.shape[0]
    a = assign.long()
    counts = torch.bincount(a, minlength=n_lists)
    cap = max(int(counts.max()) if n else 0, 1)
    order = torch.sort(a, stable=True).indices
    starts = torch.cumsum(counts, 0) - counts
    sa = a[order]
    slot = torch.arange(n, device=a.device) - starts[sa]
    lists = torch.full((n_lists, cap), -1, dtype=torch.int32,
                       device=a.device)
    lists[sa, slot] = order.to(torch.int32)
    return lists, order, slot


def query_chunk(n_queries: int, pairs_per_query: int) -> int:
    """Queries per search chunk: CHUNK_PAIRS candidate pairs, at least 1."""
    return max(1, min(n_queries, CHUNK_PAIRS // max(pairs_per_query, 1)))


class IVFIndex:
    def __init__(self, n_lists: int = 512, nprobe: int = 8, device=None):
        self.n_lists = n_lists
        self.nprobe = nprobe
        self.device = resolve_device(device)
        self.centroids: Optional[torch.Tensor] = None
        self.lists: Optional[torch.Tensor] = None   # (n_lists, cap), -1 pad
        self.data: Optional[torch.Tensor] = None
        self.spec: Optional[str] = None

    def fit(self, data, generator: Optional[torch.Generator] = None, *,
            iters: int = 10, init_centroids=None):
        """k-means (``iters`` Lloyd steps; k-means++ seeds from
        ``generator``, default a CPU generator seeded with 0, unless
        ``init_centroids`` hands them in), then the posting lists."""
        self.data = torch.as_tensor(data, dtype=torch.float32).to(
            self.device).contiguous()
        if generator is None and init_centroids is None:
            generator = torch.Generator().manual_seed(0)
        km = kmeans(generator, self.data, self.n_lists, iters=iters,
                    init_centroids=init_centroids)
        self.centroids = km.centroids
        self.lists = posting_lists(km.assignments, self.n_lists)[0]
        return self

    def search(self, queries, k: int, params=None):
        nprobe = min(param_or(params, "nprobe", self.nprobe), self.n_lists)
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device).contiguous()
        # the nprobe nearest centroids, ties by lower list id
        _, probe = l2_topk(q, self.centroids, nprobe)
        cap = self.lists.shape[1]
        step = query_chunk(q.shape[0], nprobe * cap)
        out_d, out_i = [], []
        for s in range(0, q.shape[0], step):
            cand = self.lists[probe[s:s + step].long()].reshape(
                -1, nprobe * cap)                          # (q, nprobe*cap)
            d = gather_dist(q[s:s + step], self.data, cand)  # +inf at -1
            # lists are disjoint: no dedup needed
            dk, pos = smallest_k(d, k)
            out_d.append(dk)
            out_i.append(cand.gather(1, pos.long()))
        return torch.cat(out_d), torch.cat(out_i)

    @property
    def ntotal(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def dim(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    def search_params_space(self):
        from repro_torch.core.index_api import nprobe_space
        return nprobe_space(self.n_lists)

    def memory_bytes(self) -> int:
        return int(self.data.numel() * self.data.element_size()
                   + self.lists.numel() * 4 + self.centroids.numel() * 4)

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        return {"meta": {"n_lists": self.n_lists, "nprobe": self.nprobe},
                "arrays": {"centroids": self.centroids.cpu().numpy(),
                           "lists": self.lists.cpu().numpy(),
                           "data": self.data.cpu().numpy()}}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "IVFIndex":
        meta, a = state["meta"], state["arrays"]
        idx = cls(n_lists=meta["n_lists"], nprobe=meta["nprobe"],
                  device=device)
        t = lambda name: torch.from_numpy(np.array(a[name])).to(idx.device)
        idx.centroids = t("centroids").float()
        idx.lists = t("lists").to(torch.int32).contiguous()
        idx.data = t("data").float().contiguous()
        return idx
