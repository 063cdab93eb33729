"""Recsys substrate (the reference's ``models/recsys_common.py``): one
concatenated embedding table with static row offsets, id globalisation,
single-hot lookups, the multi-hot bag, the row-sharded lookup, DLRM's
dot interaction and the two training losses (the in-batch sampled softmax
and binary cross-entropy).

All tables of a model concatenate into ONE (sum_V padded, D) matrix, so a
mesh can row-shard it evenly whatever the per-table skew
(``make_sharded_lookup``). The bag goes through the ``embedding_bag`` op:
the hand-written CUDA kernel on the card, its plain version on the CPU,
both differentiable with respect to the table (the backward kernel on the
card), so the same lookups serve and train.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import op_costs
from repro_torch.distributed.sharding import RowSharded, columns, on_meta, \
    model_size, put_row_sharded
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.layers import init_device


def table_offsets(vocabs: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocabs)])[:-1].astype(np.int64)


def padded_rows(vocabs: Sequence[int], multiple: int = 512) -> int:
    """Concatenated row count padded so any mesh axis (<=512) divides it."""
    total = int(sum(vocabs))
    return -(-total // multiple) * multiple


def init_tables(generator: torch.Generator, vocabs: Sequence[int],
                dim: int, device=None) -> torch.Tensor:
    """(padded_rows, dim) f32 normal rows times dim^-0.5, drawn on the
    generator's device or ``device`` (scaled in place: a full-size table
    is 14 GB)."""
    t = torch.randn((padded_rows(vocabs), dim), generator=generator,
                    device=init_device(generator, device))
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
    one = on_meta(mesh)

    def local(table_local, ids, shard):
        loc = ids - shard * rows_local
        mask = (loc >= 0) & (loc < table_local.shape[0])
        rows = table_local[loc.clamp(0, table_local.shape[0] - 1)]
        return torch.where(mask[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))

    def psum(table, ids, group, groups=1):
        # each (group, shard) take counted as that device's; on a meta
        # mesh the first stands in for every shard (sharding.shard_map)
        # and its merge for ``groups`` groups' (the common work's split
        # over the groups gives a device its own)
        parts = [op_costs.in_shard(
            (group, s), local, table.local(s, cols[group, s]),
            ids.to(cols[group, s]), s) for s in range(1 if one else n_shards)]
        op_costs.record_collective("all-reduce", groups * parts[0].numel()
                                   * parts[0].element_size(), n_shards)
        with op_costs.suspended():
            acc = parts[0].to(ids.device)
            for rows in parts[1:]:
                acc = acc + rows.to(ids.device)
            return acc

    def fn(table, flat_ids):
        if not isinstance(table, RowSharded):
            table = put_row_sharded(mesh, table)
        dp = cols.shape[0]
        if flat_ids.shape[0] % dp:              # every group merges all
            return psum(table, flat_ids, 0, dp)
        parts = flat_ids.split(flat_ids.shape[0] // dp) if dp > 1 \
            else (flat_ids,)
        if one:                                 # the groups alike
            return op_costs.stand_in(psum(table, parts[0], 0, dp), dp)
        rows = [psum(table, part, g) for g, part in enumerate(parts)]
        if len(rows) == 1:
            return rows[0]
        with op_costs.suspended():
            return torch.cat(rows)

    return fn


def dot_interaction(vectors: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction: (B, F, D) -> (B, F*(F-1)/2) pairwise dots, the
    upper triangle in ``triu_indices(F, 1)`` order."""
    b, f, d = vectors.shape
    z = torch.einsum("bfd,bgd->bfg", vectors, vectors)
    iu = torch.triu_indices(f, f, 1, device=vectors.device)
    return z[:, iu[0], iu[1]]


LOSS_BLOCK_BYTES = 1 << 31   # the in-batch logits a loss block holds


def sampled_softmax_loss(user_vecs: torch.Tensor, item_vecs: torch.Tensor,
                         log_q: Optional[torch.Tensor] = None,
                         temperature: float = 0.05) -> torch.Tensor:
    """In-batch softmax with logQ correction (two-tower retrieval): the
    mean over rows of -log softmax(u @ v.T / temperature - log_q)[i, i].

    Each row's log-softmax is ``F.cross_entropy``'s (the reference's
    log_softmax and diagonal take), over blocks of rows whose logits take
    at most LOSS_BLOCK_BYTES: at B = 65,536 the (B, B) logits are 17.2 GB,
    and autograd keeps each block's log-softmax and frees the rest, so no
    buffer that size is ever allocated. The division and the logQ shift
    run in place on each product (neither backward needs its input)."""
    b = user_vecs.shape[0]
    rows = max(1, LOSS_BLOCK_BYTES // (4 * max(item_vecs.shape[0], 1)))
    total = None
    for i in range(0, b, rows):
        logits = (user_vecs[i:i + rows] @ item_vecs.T).div_(temperature)
        if log_q is not None:
            logits.sub_(log_q[None, :])
        labels = torch.arange(i, i + logits.shape[0], device=logits.device)
        part = torch.nn.functional.cross_entropy(logits, labels,
                                                 reduction="sum")
        total = part if total is None else total + part
    return total / b


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, in the reference's form:
    max(x, 0) - x * y + log1p(exp(-|x|))."""
    logits = logits.reshape(labels.shape)
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()
