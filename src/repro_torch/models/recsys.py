"""Recsys models of the port (the reference's ``models/recsys.py``): the
two-tower retrieval model so far.

    model = INIT["two-tower-retrieval"](generator, cfg)
    SCORE["two-tower-retrieval"](model, cfg, batch)     # (B,) scores
    model.retrieval(batch, cand_items, cand_cates)      # (C,) scores

A batch is the reference's dict: ``batch["sparse_ids"]`` holds one (B, L_t)
int32 tensor per table. The user's history bag goes through
``recsys_common.bag_lookup`` and so through the ``embedding_bag`` kernel on
the card; the reference builds the same function from a take and a masked
sum (``_bag``). The row-sharded lookup hook (``lookup_fn``) is not ported:
a non-None one raises. Serving only: the bag kernel has no backward yet, so
training waits for ROADMAP Queue 1 item 10.5; call under
``torch.inference_mode()``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import NOT_PORTED
from repro_torch.configs.base import RecsysConfig
from repro_torch.models import recsys_common as C
from repro_torch.models.layers import MLP, mlp_init


def _no_lookup_fn(fn):
    if fn is not None:
        raise NotImplementedError(
            "lookup_fn: the row-sharded lookup is not ported yet (ROADMAP "
            "Queue 1 item 9)")


def _tables(generator, cfg):
    return C.init_tables(generator, cfg.table_vocabs, cfg.embed_dim)


def _offsets(cfg):
    return C.table_offsets(cfg.table_vocabs)


def _lk(fn, table, ids):
    """Every single-hot table access goes through here. ids may be any
    shape; returns ids.shape + (D,)."""
    _no_lookup_fn(fn)
    rows = table[ids.reshape(-1)]
    return rows.reshape(*ids.shape, table.shape[1])


def _bag(fn, table, ids, combiner="mean"):
    """Multi-hot (-1 padded) bag: the ``embedding_bag`` op."""
    _no_lookup_fn(fn)
    return C.bag_lookup(table, ids, combiner)


def _l2norm(x):
    norm = torch.sqrt((x * x).sum(-1, keepdim=True))
    return x / norm.clamp_min(1e-6)


# tables: (user_id, history_item, item_id, item_category)
class TwoTower(nn.Module):
    """Dual encoder: a user tower over [user ; mean(history)] and an item
    tower over [item ; category], both L2-normalised, scored by a dot."""

    def __init__(self, cfg: RecsysConfig, table: torch.Tensor,
                 user_tower: MLP, item_tower: MLP):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.user_tower = user_tower
        self.item_tower = item_tower

    def user_embed(self, batch, lookup_fn=None) -> torch.Tensor:
        off = _offsets(self.cfg)
        ids = batch["sparse_ids"]
        u = _lk(lookup_fn, self.table, ids[0][:, 0] + int(off[0]))
        hist = torch.where(ids[1] >= 0, ids[1] + int(off[1]), -1)
        h = _bag(lookup_fn, self.table, hist, "mean")
        return _l2norm(self.user_tower(torch.cat([u, h], dim=1)))

    def item_embed(self, item_ids, cate_ids, lookup_fn=None) -> torch.Tensor:
        off = _offsets(self.cfg)
        i = _lk(lookup_fn, self.table, item_ids + int(off[2]))
        c = _lk(lookup_fn, self.table, cate_ids + int(off[3]))
        return _l2norm(self.item_tower(torch.cat([i, c], dim=1)))

    def score(self, batch, lookup_fn=None) -> torch.Tensor:
        u = self.user_embed(batch, lookup_fn)
        ids = batch["sparse_ids"]
        v = self.item_embed(ids[2][:, 0], ids[3][:, 0], lookup_fn)
        return (u * v).sum(1)

    def retrieval(self, batch, cand_items, cand_cates,
                  lookup_fn=None) -> torch.Tensor:
        """1 query vs C candidates: one (1, D) x (D, C) product."""
        u = self.user_embed(batch, lookup_fn)                      # (1, D)
        v = self.item_embed(cand_items, cand_cates, lookup_fn)     # (C, D)
        return (u @ v.T)[0]                                        # (C,)


def two_tower_init(generator: torch.Generator, cfg: RecsysConfig
                   ) -> TwoTower:
    """Table and towers drawn from ``generator`` on its device."""
    d = cfg.embed_dim
    table = _tables(generator, cfg)
    user = mlp_init(generator, (2 * d,) + tuple(cfg.tower_mlp))
    item = mlp_init(generator, (2 * d,) + tuple(cfg.tower_mlp))
    return TwoTower(cfg, table, user, item)


def two_tower_score(params: TwoTower, cfg, batch, lookup_fn=None):
    return params.score(batch, lookup_fn)


INIT = {"two-tower-retrieval": two_tower_init}
SCORE = {"two-tower-retrieval": two_tower_score}


def family_of(cfg: RecsysConfig) -> str:
    name = cfg.name.replace("-smoke", "")
    for k in INIT:
        if name.startswith(k.split("-")[0]):
            return k
    for arch_id, item in NOT_PORTED.items():
        if name.startswith(arch_id.split("-")[0]):
            raise NotImplementedError(
                f"recsys family of {cfg.name!r} is not ported yet ({item})")
    raise KeyError(cfg.name)
