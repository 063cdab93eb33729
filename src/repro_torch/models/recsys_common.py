"""Recsys substrate (the reference's ``models/recsys_common.py``): one
concatenated embedding table with static row offsets, id globalisation,
single-hot lookups and the multi-hot bag.

All tables of a model concatenate into ONE (sum_V padded, D) matrix. The
bag goes through the ``embedding_bag`` op: the hand-written CUDA kernel on
the card, its plain version on the CPU. The row-sharded lookup, the DLRM
interaction and the training losses are not ported (ROADMAP Queue 1
items 9 and 10.5).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

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
