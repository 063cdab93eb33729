"""HNSW — paper Fig. 1 baseline ("HNSW32,Flat"), the reference's
``core/hnsw.py``.

The build is the classic sequential greedy insert on the host, in numpy,
the reference's code as it is (seeded ``np.random.default_rng``), so one
seed gives the reference's layers id for id. Search runs on the device:

  * the upper layers are stacked into one padded (L, N, m) table, and the
    greedy descent steps the whole query batch at once (``descend_upper``:
    each lane masked once it stops, one host read per step);
  * with ``ep_clusters > 1`` the paper's §3.1 entry-point knob replaces
    the hierarchy (spec ``HNSW32,EP16``);
  * layer 0 is the port's ``beam_search`` (on the card, one ``beam_hops``
    launch per search).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.beam_search import _sqdist_rows, beam_search
from repro_torch.core.device import resolve_device
from repro_torch.core.entry_points import EntryPointSelector, fit_entry_points


def descend_upper(queries: torch.Tensor, db: torch.Tensor,
                  upper: torch.Tensor, entry: int) -> torch.Tensor:
    """Greedy descent through the stacked upper layers, whole batch at once.

    queries: (Q, D); db: (N, D); upper: (L, N, m) int32 (-1 padded, row li
    holding graph layer li+1); entry: the top-level entry node. Returns
    (Q,) int32 layer-0 entry ids. Per layer, each lane moves to its
    neighbour nearest the query (the first of equal minima, ``argmin``'s
    rule) while that one is strictly nearer than where it stands, in the
    norm-expansion arithmetic of the reference's ``_sqdist_rows``.
    """
    q = queries.float()
    qn = q.shape[0]
    cur = torch.full((qn,), int(entry), dtype=torch.int32, device=q.device)
    cur_d = _sqdist_rows(q, db[cur.long()][:, None, :])[:, 0]
    for li in range(upper.shape[0] - 1, -1, -1):     # top -> layer 1
        table = upper[li]
        live = torch.ones(qn, dtype=torch.bool, device=q.device)
        while True:
            nbrs = table[cur.long()]                           # (Q, m)
            valid = nbrs >= 0
            safe = torch.where(valid, nbrs, 0)
            d = torch.where(valid, _sqdist_rows(q, db[safe.long()]),
                            torch.inf)
            j = torch.argmin(d, dim=1, keepdim=True)
            dj = d.gather(1, j)[:, 0]
            live = live & (dj < cur_d)
            cur = torch.where(live, safe.gather(1, j)[:, 0], cur)
            cur_d = torch.where(live, dj, cur_d)
            if not bool(live.any()):                      # one host read
                break
    return cur


class HNSWIndex:
    def __init__(self, m: int = 32, ef_construction: int = 64,
                 ef_search: int = 64, seed: int = 0, ep_clusters: int = 0,
                 device=None):
        self.m = m
        self.m0 = 2 * m
        self.ef_c = ef_construction
        self.ef_s = ef_search
        self.ep_clusters = ep_clusters
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.layers: List[np.ndarray] = []     # [L][n, deg] neighbor ids
        self.node_level: Optional[np.ndarray] = None
        self.entry: int = 0
        self.data: Optional[np.ndarray] = None
        self.eps: Optional[EntryPointSelector] = None
        self.spec: Optional[str] = None
        # device-resident search state (built by _device_tables)
        self._db: Optional[torch.Tensor] = None
        self._nbr0: Optional[torch.Tensor] = None
        self._upper: Optional[torch.Tensor] = None

    # -- build (host, sequential greedy insert) ---------------------------
    def fit(self, data, generator: Optional[torch.Generator] = None):
        """Host build from the constructor's seed; ``generator`` draws the
        entry-point k-means++ seeds (``ep_clusters > 1``; default a CPU
        generator seeded with 0)."""
        x = torch.as_tensor(data, dtype=torch.float32).cpu().numpy()
        n = x.shape[0]
        self.data = x
        ml = 1.0 / math.log(self.m)
        levels = np.minimum(
            (-np.log(self.rng.uniform(size=n)) * ml).astype(np.int64), 8)
        max_level = int(levels.max())
        self.node_level = levels
        self.layers = [np.full((n, self.m0 if l == 0 else self.m), -1,
                               np.int32) for l in range(max_level + 1)]
        order = np.arange(n)
        self.entry = int(order[np.argmax(levels)])
        inserted: List[int] = []
        for i in order:
            self._insert(int(i), x, levels[int(i)], inserted)
            inserted.append(int(i))
        self._finalize_device(generator)
        return self

    def _device_tables(self):
        """Move everything the search path touches onto the device once."""
        self._db = torch.from_numpy(self.data).to(self.device).contiguous()
        self._nbr0 = torch.from_numpy(self.layers[0]).to(
            self.device).contiguous()
        if len(self.layers) > 1:
            self._upper = torch.from_numpy(np.stack(self.layers[1:])).to(
                self.device)
        else:
            self._upper = torch.full((0, self.data.shape[0], self.m), -1,
                                     dtype=torch.int32, device=self.device)

    def _finalize_device(self, generator=None):
        self._device_tables()
        if self.ep_clusters > 1:
            generator = generator if generator is not None else \
                torch.Generator().manual_seed(0)
            self.eps = fit_entry_points(generator, self._db,
                                        self.ep_clusters)

    def _greedy(self, q: np.ndarray, start: int, layer: np.ndarray) -> int:
        cur = start
        cur_d = float(((self.data[cur] - q) ** 2).sum())
        improved = True
        while improved:
            improved = False
            nbrs = layer[cur]
            nbrs = nbrs[nbrs >= 0]
            if len(nbrs) == 0:
                break
            d = ((self.data[nbrs] - q) ** 2).sum(1)
            j = int(np.argmin(d))
            if d[j] < cur_d:
                cur, cur_d = int(nbrs[j]), float(d[j])
                improved = True
        return cur

    def _search_layer(self, q, entry, layer, ef) -> List[int]:
        visited = {entry}
        d0 = float(((self.data[entry] - q) ** 2).sum())
        cand = [(d0, entry)]
        best = [(d0, entry)]
        while cand:
            cand.sort()
            d, u = cand.pop(0)
            if d > max(b[0] for b in best):
                break
            for v in layer[u]:
                if v < 0 or v in visited:
                    continue
                visited.add(int(v))
                dv = float(((self.data[v] - q) ** 2).sum())
                if len(best) < ef or dv < max(b[0] for b in best):
                    cand.append((dv, int(v)))
                    best.append((dv, int(v)))
                    best.sort()
                    best[:] = best[:ef]
        return [u for _, u in best]

    def _insert(self, i: int, x: np.ndarray, level: int,
                inserted: List[int]):
        if not inserted:
            return
        q = x[i]
        cur = self.entry
        top = int(self.node_level[self.entry])
        for l in range(top, level, -1):
            if l < len(self.layers):
                cur = self._greedy(q, cur, self.layers[l])
        for l in range(min(level, top), -1, -1):
            cands = self._search_layer(q, cur, self.layers[l], self.ef_c)
            deg = self.m0 if l == 0 else self.m
            sel = self._select(q, cands, deg)
            self.layers[l][i, :len(sel)] = sel
            for v in sel:                       # reverse edges with prune
                row = self.layers[l][v]
                free = np.nonzero(row < 0)[0]
                if free.size:
                    row[free[0]] = i
                else:
                    ds = ((x[row] - x[v]) ** 2).sum(1)
                    di = ((x[i] - x[v]) ** 2).sum()
                    worst = int(np.argmax(ds))
                    if di < ds[worst]:
                        row[worst] = i
            cur = sel[0] if sel else cur
        if level > int(self.node_level[self.entry]):
            self.entry = i

    def _select(self, q, cands: List[int], deg: int) -> List[int]:
        d = ((self.data[cands] - q) ** 2).sum(1)
        order = np.argsort(d)
        return [int(cands[j]) for j in order[:deg]]

    @property
    def ntotal(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def dim(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    def search_params_space(self):
        from repro_torch.core.index_api import ef_search_space
        return ef_search_space()

    def memory_bytes(self) -> int:
        total = int(self.data.size * 4
                    + sum(layer.size for layer in self.layers) * 4)
        if self.eps is not None:
            total += int((self.eps.centroids.numel()
                          + self.eps.member_ids.numel()) * 4)
        return total

    # -- persistence (core/persist.py) ------------------------------------
    def state_dict(self) -> dict:
        arrays = {"data": self.data, "node_level": self.node_level}
        for li, layer in enumerate(self.layers):
            arrays[f"layer_{li}"] = layer
        if self.eps is not None:
            arrays["eps_centroids"] = self.eps.centroids.cpu().numpy()
            arrays["eps_member_ids"] = self.eps.member_ids.cpu().numpy()
        return {"meta": {"m": self.m, "ef_construction": self.ef_c,
                         "ef_search": self.ef_s,
                         "ep_clusters": self.ep_clusters,
                         "entry": int(self.entry),
                         "n_layers": len(self.layers)},
                "arrays": arrays}

    @classmethod
    def from_state(cls, state: dict, device=None) -> "HNSWIndex":
        meta, a = state["meta"], state["arrays"]
        idx = cls(m=meta["m"], ef_construction=meta["ef_construction"],
                  ef_search=meta["ef_search"],
                  ep_clusters=meta["ep_clusters"], device=device)
        idx.data = np.asarray(a["data"], np.float32)
        idx.node_level = np.asarray(a["node_level"])
        idx.layers = [np.asarray(a[f"layer_{li}"], np.int32)
                      for li in range(meta["n_layers"])]
        idx.entry = int(meta["entry"])
        # device tables only — the EP selector is restored verbatim, never
        # re-fit (k-means from a fresh generator would break bit-identity)
        idx._device_tables()
        if "eps_centroids" in a:
            t = lambda name: torch.from_numpy(np.array(a[name])).to(
                idx.device)
            idx.eps = EntryPointSelector(
                centroids=t("eps_centroids").float(),
                member_ids=t("eps_member_ids").to(torch.int32))
        return idx

    # -- search (device end to end) ----------------------------------------
    def entry_points(self, queries) -> torch.Tensor:
        """(Q, D) -> (Q,) int32 layer-0 entry ids."""
        q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
        if self.eps is not None:                 # paper §3.1 EP knob
            return self.eps.select(q)
        if self._upper.shape[0] == 0:            # single-layer graph
            return torch.full((q.shape[0],), self.entry, dtype=torch.int32,
                              device=self.device)
        return descend_upper(q, self._db, self._upper, self.entry)

    def search(self, queries, k: int, params=None, *,
               ef: Optional[int] = None, mode: Optional[str] = None):
        if params is not None:
            ef = ef if ef is not None else params.ef_search
            mode = mode if mode is not None else params.mode
        ef = ef or self.ef_s
        mode = mode or "while"
        q = torch.as_tensor(queries, dtype=torch.float32).to(
            self.device).contiguous()
        entries = self.entry_points(q)
        d, i, _ = beam_search(q, self._db, self._nbr0, entries,
                              ef=max(ef, k), k=k, mode=mode,
                              layout="batched")
        return d, i
