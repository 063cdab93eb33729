"""α-RNG occlusion pruning + rebuild-free ``reprune`` (the reference's
``core/build/prune.py``; Zhang et al., "Prune, Don't Rebuild").

``alpha_prune`` generalizes NSG's MRNG edge-selection rule: scanning a
node's candidate pool nearest-first, candidate q is kept unless some
already-kept r occludes it — ``d(r, q) < alpha * d(p, q)`` on squared
distances. ``alpha = 1`` is the MRNG rule.

The greedy scan only ever tests a candidate against earlier-kept ones, so
pruning at a smaller ``degree`` keeps a prefix of the max-degree scan's
survivors, and re-scanning a pruned adjacency at ``alpha = 1`` keeps every
edge. ``reprune`` and ``reprune_family`` use both: a family of
(alpha, degree) graphs is derived from one cached max-degree graph with
O(N * R) gather-distances and one occlusion pass — no rebuild.

The occlusion scan itself is ``kernels/alpha_scan``: one kernel launch per
row chunk on CUDA (the reference's one compiled loop per chunk), its plain
version on the CPU.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels.alpha_scan import alpha_scan
from repro_torch.kernels.gather_dist import gather_dist
from repro_torch.kernels.topk_merge.ref import mark_dups as _mark_dups_block

# rows per block of ``mark_dups``: its (rows, L, L) bool temp stays small
_DUP_ROWS = 4096


def pairwise_rows_sqdist(q: torch.Tensor, data: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """(B, D) queries vs per-row gathered ids (B, K) -> (B, K) sq dists
    (diff-square form, +inf for ids < 0): the ``gather_dist`` function,
    so on the card it runs the kernel."""
    return gather_dist(q, data, ids)


def rows_sqdist_in_chunks(data: torch.Tensor, ids: torch.Tensor,
                          chunk: int = 2048) -> torch.Tensor:
    """Chunked ``pairwise_rows_sqdist`` of row i vs its (N, K) id table."""
    return torch.cat([pairwise_rows_sqdist(data[s:s + chunk], data,
                                           ids[s:s + chunk])
                      for s in range(0, ids.shape[0], chunk)])


def mark_dups(ids: torch.Tensor) -> torch.Tensor:
    """True at positions holding a value already seen to the left, and at
    ids < 0; row blocks bound the (rows, L, L) temp."""
    return torch.cat([_mark_dups_block(ids[s:s + _DUP_ROWS])
                      for s in range(0, ids.shape[0], _DUP_ROWS)])


def alpha_prune(data: torch.Tensor, node_ids: torch.Tensor,
                cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                degree: int, alpha: float = 1.0) -> torch.Tensor:
    """α-RNG edge selection for a block of nodes.

    node_ids: (B,); cand_ids/cand_dists: (B, L) distance-ascending candidate
    pools (-1 padded). Returns (B, degree) pruned neighbor ids.
    """
    return alpha_scan(data, node_ids, cand_ids, cand_dists, degree,
                      alpha)[0]


def prune_in_chunks(data, node_ids, cand_ids, cand_dists, degree, chunk,
                    alpha: float = 1.0):
    """``alpha_prune`` over row chunks (bounds the block size)."""
    return torch.cat([
        alpha_prune(data, node_ids[s:s + chunk], cand_ids[s:s + chunk],
                    cand_dists[s:s + chunk], degree, alpha)
        for s in range(0, node_ids.shape[0], chunk)])


def alpha_prune_mask(data: torch.Tensor, node_ids: torch.Tensor,
                     cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                     degree: int, alpha: float = 1.0) -> torch.Tensor:
    """``alpha_prune``'s survivors as a (B, L) bool position mask: the ids
    ``alpha_prune`` returns are ``cand_ids`` at the True positions, in
    order."""
    return alpha_scan(data, node_ids, cand_ids, cand_dists, degree,
                      alpha)[1]


def sorted_adjacency_chunk(data: torch.Tensor, rows: torch.Tensor,
                           neighbors: torch.Tensor):
    """One row chunk's adjacency as distance-ascending pools (ids, dists).

    ``rows`` are the chunk's own vectors (``data[s:e]``); the gather runs
    against the full ``data``. The sort is stable: equal distances keep
    their adjacency order, and -1 slots (+inf) go last.
    """
    d = pairwise_rows_sqdist(rows, data, neighbors)
    order = torch.sort(d, dim=1, stable=True).indices
    return neighbors.gather(1, order), d.gather(1, order)


def sorted_adjacency(data: torch.Tensor, neighbors: torch.Tensor,
                     chunk: int = 2048):
    """Adjacency rows as distance-ascending candidate pools (ids, dists).

    Materializes the full (N, R) f32 table, the small-N / parity form;
    out-of-core callers stream ``sorted_adjacency_chunk`` instead. The
    sort is stable, as the chunk's.
    """
    d = rows_sqdist_in_chunks(data, neighbors, chunk)
    order = torch.sort(d, dim=1, stable=True).indices
    return neighbors.gather(1, order), d.gather(1, order)


def reprune(data: torch.Tensor, neighbors: torch.Tensor, *,
            alpha: float = 1.0, degree: Optional[int] = None,
            chunk: int = 2048) -> torch.Tensor:
    """Derive an (alpha, degree) adjacency from a cached max-degree one.

    ``neighbors`` is an (N, R_max) pruned adjacency (the alpha=1
    max-degree graph a build cached). Each row chunk is sorted by distance
    and re-scanned; the (N, R) f32 distance table never exists whole.
    """
    n, rmax = neighbors.shape
    degree = rmax if degree is None else min(degree, rmax)
    node_ids = torch.arange(n, dtype=torch.int32, device=neighbors.device)
    outs = []
    for s in range(0, n, chunk):
        cand_i, cand_d = sorted_adjacency_chunk(data, data[s:s + chunk],
                                                neighbors[s:s + chunk])
        outs.append(alpha_prune(data, node_ids[s:s + chunk], cand_i, cand_d,
                                degree, alpha))
    return torch.cat(outs)


def _pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(..., L) bool survivor mask -> (..., ceil(L/32)) int32 words: bit b
    of word w is position 32 w + b (the reference's uint32 words, held as
    int32 of the same bits)."""
    l = mask.shape[-1]
    w = -(-l // 32)
    m = torch.nn.functional.pad(mask, (0, w * 32 - l))
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    words = (m.reshape(m.shape[:-1] + (w, 32)).long() * weights).sum(-1)
    return words.to(torch.int32)            # wraps bit 31 into the sign


def _family_member(cand_ids: torch.Tensor, masks_a: torch.Tensor,
                   degree: int) -> torch.Tensor:
    """Unpack one alpha's survivor bitmask into its (N, degree) member:
    the first ``degree`` survivors of the max-degree scan (the prefix
    property), so one mask serves every degree."""
    n, rmax = cand_ids.shape
    pos = torch.arange(rmax, device=cand_ids.device)
    word = masks_a[:, pos // 32].long()                         # (N, R)
    bits = ((word >> (pos % 32)) & 1) != 0
    rank = torch.cumsum(bits.to(torch.int64), dim=1)
    take = bits & (rank <= degree)
    slot = torch.where(take, rank - 1, degree)  # overflow col, sliced off
    out = torch.full((n, degree + 1), -1, dtype=torch.int32,
                     device=cand_ids.device)
    out.scatter_(1, slot, torch.where(take, cand_ids.to(torch.int32), -1))
    return out[:, :degree]


class RepruneFamily:
    """Memory-lean (alpha, degree) reprune grid: packed survivor bitmasks.

    Holds one 32-bit word per (alpha, node, 32 candidates) — an
    ``(A, N, ceil(R/32))`` array — against the one shared distance-ascending
    max-degree adjacency. ``member(a_idx, degree)`` reconstructs any grid
    member in one unpack pass, equal to the materialized stack's slice.
    """

    def __init__(self, alphas, cand_ids: torch.Tensor, masks: torch.Tensor):
        self.alphas = tuple(float(a) for a in alphas)
        self.cand_ids = cand_ids     # (N, R) sorted max-degree adjacency
        self.masks = masks           # (A, N, W) int32 survivor bits

    @property
    def shape(self):
        n, rmax = self.cand_ids.shape
        return (len(self.alphas), n, rmax)

    def nbytes(self) -> int:
        """Grid storage beyond the shared adjacency (the lean part)."""
        return int(self.masks.numel()) * 4

    def member(self, a_idx: int, degree: Optional[int] = None
               ) -> torch.Tensor:
        """(N, degree) ids == ``reprune(..., alpha=alphas[a_idx], degree)``."""
        rmax = self.cand_ids.shape[1]
        degree = rmax if degree is None else min(degree, rmax)
        return _family_member(self.cand_ids, self.masks[a_idx], degree)

    def materialize(self) -> torch.Tensor:
        """The full (A, N, R) stack (tests / small-N)."""
        return torch.stack([self.member(i) for i in range(len(self.alphas))])


def reprune_family(data: torch.Tensor, neighbors: torch.Tensor,
                   alphas: Sequence[float], chunk: int = 2048,
                   materialize: bool = True):
    """The whole (alpha, degree) grid in one pass over the row chunks.

    Every alpha shares the chunk's distance-ascending candidate pool (the
    sorted max-degree adjacency), so the A alphas run as one occlusion
    scan over an (A * chunk)-row block with a per-row alpha; a smaller
    degree is a prefix of the max-degree scan, so no degree axis exists.
    ``materialize=True`` returns the (A, N, R_max) stack, with
    ``stack[i, :, :d] == reprune(data, neighbors, alpha=alphas[i],
    degree=d)``; ``materialize=False`` returns a ``RepruneFamily`` holding
    only the packed survivor bitmasks, whose ``member(i, d)`` rebuilds the
    same arrays on demand.
    """
    n, rmax = neighbors.shape
    dev = neighbors.device
    node_ids = torch.arange(n, dtype=torch.int32, device=dev)
    al = torch.tensor([float(a) for a in alphas], dtype=torch.float32,
                      device=dev)
    n_alpha = al.shape[0]
    outs, cand_parts = [], []
    for s in range(0, n, chunk):
        ci, cd = sorted_adjacency_chunk(data, data[s:s + chunk],
                                        neighbors[s:s + chunk])
        b = ci.shape[0]
        cand_parts.append(ci)
        keep, mask = alpha_scan(
            data, node_ids[s:s + chunk].repeat(n_alpha), ci.repeat(n_alpha, 1),
            cd.repeat(n_alpha, 1), rmax, al.repeat_interleave(b))
        if materialize:
            outs.append(keep.view(n_alpha, b, rmax))
        else:
            outs.append(_pack_mask(mask.view(n_alpha, b, -1)))
    stacked = torch.cat(outs, dim=1)
    if materialize:
        return stacked
    return RepruneFamily(alphas, torch.cat(cand_parts), stacked)


def nsg_from_neighbors(data: torch.Tensor, neighbors: torch.Tensor, medoid,
                       *, knn_ids: Optional[torch.Tensor] = None,
                       finish_backend: str = "auto"):
    """Pruned adjacency -> servable ``NSGGraph`` (connectivity repair).

    The shared tail of every rebuild-free derivation: ``reprune_nsg`` and
    the tuner's ``reprune_family`` lookups both end here. ``knn_ids``
    supplies repair parents (the build-time kNN table if the caller kept
    it; default the adjacency itself); ``finish_backend`` picks the repair
    (``build/finish.py``: the device's batched rounds by default, the host
    loop for parity).
    """
    from repro_torch.core.build.finish import repair
    from repro_torch.core.nsg import NSGGraph

    parents = knn_ids if knn_ids is not None else neighbors
    nbrs, _ = repair(data, neighbors, medoid, parents,
                     backend=finish_backend)
    return NSGGraph(neighbors=nbrs.to(torch.int32).contiguous(),
                    medoid=torch.as_tensor(medoid, dtype=torch.int32,
                                           device=neighbors.device))


def reprune_nsg(data: torch.Tensor, graph, *, alpha: float = 1.0,
                degree: Optional[int] = None,
                knn_ids: Optional[torch.Tensor] = None, chunk: int = 2048,
                finish_backend: str = "auto"):
    """``reprune`` + connectivity repair -> a servable ``NSGGraph``."""
    nbrs = reprune(data, graph.neighbors, alpha=alpha, degree=degree,
                   chunk=chunk)
    return nsg_from_neighbors(data, nbrs, graph.medoid, knn_ids=knn_ids,
                              finish_backend=finish_backend)
