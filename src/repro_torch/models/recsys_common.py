"""Recsys substrate (the reference's ``models/recsys_common.py``): one
concatenated embedding table with static row offsets, id globalisation,
single-hot lookups, the multi-hot bag, the row-sharded lookup and DLRM's
dot interaction.

All tables of a model concatenate into ONE (sum_V padded, D) matrix, so a
mesh can row-shard it evenly whatever the per-table skew
(``make_sharded_lookup``). The bag goes through the ``embedding_bag`` op:
the hand-written CUDA kernel on the card, its plain version on the CPU.
The training losses are not ported (ROADMAP Queue 1 item 10.5).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import RowSharded, columns, \
    model_size, put_row_sharded
from repro_torch.kernels.embedding_bag import embedding_bag


def table_offsets(vocabs: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocabs)])[:-1].astype(np.int64)


def padded_rows(vocabs: Sequence[int], multiple: int = 512) -> int:
    """Concatenated row count padded so any mesh axis (<=512) divides it."""
    total = int(sum(vocabs))
    return -(-total // multiple) * multiple


def init_tables(generator: torch.Generator, vocabs: Sequence[int],
                dim: int) -> torch.Tensor:
    """(padded_rows, dim) f32 normal rows times dim^-0.5, drawn on the
    generator's device (scaled in place: a full-size table is 14 GB)."""
    t = torch.randn((padded_rows(vocabs), dim), generator=generator,
                    device=generator.device)
    return t.mul_(dim ** -0.5)


def globalize_ids(ids_per_table: List[torch.Tensor],
                  offsets: np.ndarray) -> torch.Tensor:
    """[(B, L_t)] -> (B, sum L_t) ids into the concatenated table."""
    return torch.cat([ids + int(offsets[t])
                      for t, ids in enumerate(ids_per_table)], dim=1)


def lookup(table: torch.Tensor, global_ids: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T, D) single-hot gather."""
    return table[global_ids]


def bag_lookup(table: torch.Tensor, ids: torch.Tensor,
               combiner: str = "mean") -> torch.Tensor:
    """(B, L) multi-hot (-1 padded) -> (B, D) through ``embedding_bag``."""
    return embedding_bag(table, ids, None, combiner)


def make_sharded_lookup(mesh, total_rows: int):
    """Row-sharded embedding lookup: a masked take per shard, then the
    shards' rows summed in shard order (the reference's ``psum`` over
    ``model``).

    The table is a ``RowSharded`` over ``mesh`` (a tensor is split over its
    ``model`` axis first), block s holding rows [s * ceil(total_rows / S),
    ...). The flat ids split over the batch groups when they divide evenly;
    otherwise (tiny query batches) every group takes all of them and group
    0's result is kept, as the reference's replicated fallback. Returns
    fn(table, flat_ids (N,)) -> (N, D) on the ids' device. An id no shard
    holds reads zeros.
    """
    n_shards = model_size(mesh)
    rows_local = -(-total_rows // n_shards)
    cols = columns(mesh)                        # (groups, shards)

    def local(table_local, ids, shard):
        loc = ids - shard * rows_local
        mask = (loc >= 0) & (loc < table_local.shape[0])
        rows = table_local[loc.clamp(0, table_local.shape[0] - 1)]
        return torch.where(mask[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))

    def psum(table, ids, group):
        acc = None
        for s in range(n_shards):
            dev = cols[group, s]
            rows = local(table.local(s, dev), ids.to(dev), s).to(ids.device)
            acc = rows if acc is None else acc + rows
        return acc

    def fn(table, flat_ids):
        if not isinstance(table, RowSharded):
            table = put_row_sharded(mesh, table)
        dp = cols.shape[0]
        if flat_ids.shape[0] % dp:
            return psum(table, flat_ids, 0)
        parts = flat_ids.split(flat_ids.shape[0] // dp) if dp > 1 \
            else (flat_ids,)
        return torch.cat([psum(table, part, g)
                          for g, part in enumerate(parts)])

    return fn


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction: (B, F, D) -> (B, F*(F-1)/2) pairwise dots, the
    upper triangle in ``triu_indices(F, 1)`` order."""
    b, f, d = vectors.shape
    z = torch.einsum("bfd,bgd->bfg", vectors, vectors)
    iu = torch.triu_indices(f, f, 1, device=vectors.device)
    return z[:, iu[0], iu[1]]
