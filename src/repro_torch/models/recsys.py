"""Recsys models of the port (the reference's ``models/recsys.py``): DLRM,
the two-tower retrieval model, SASRec and DIN, as ``nn.Module``s, and
their training losses.

    model = INIT[family](generator, cfg)
    SCORE[family](model, cfg, batch)                    # (B,) scores
    model.retrieval(batch, cand_items[, cand_cates])    # (C,) scores
    LOSS[family](model, cfg, batch) -> (loss, {"loss": loss})

A batch is the reference's dict: ``batch["sparse_ids"]`` holds one (B, L_t)
int32 tensor per table, with ``dense`` (DLRM), ``history`` /
``history_len`` / ``target`` (SASRec, DIN) and ``label`` (DLRM, DIN)
beside it. Every single-hot table access goes through ``_lk`` and its
``lookup_fn`` hook: a plain take by default, ``recsys_common.
make_sharded_lookup``'s row-sharded take on a mesh. The two-tower user
history goes through ``recsys_common.bag_lookup`` and so through the
``embedding_bag`` kernel on the card, forward and backward; the reference
builds the same function from a take and a masked sum (``_bag``), which
XLA differentiates into a scatter-add.

Every weight is a trainable parameter, as every leaf of the reference's
params trains. The serve steps run under ``torch.inference_mode()``, so
serving builds no autograd graph and allocates no gradient.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models import recsys_common as C
from repro_torch.models.layers import MLP, dense_init, init_device, \
    mlp_init, rms_norm, sdpa


def _tables(generator, cfg, device=None):
    return C.init_tables(generator, cfg.table_vocabs, cfg.embed_dim, device)


def _offsets(cfg):
    return C.table_offsets(cfg.table_vocabs)


def _lk(fn, table, ids):
    """Every single-hot table access goes through here: ``fn`` is the
    row-sharded lookup at scale, a plain take otherwise. ids may be any
    shape; returns ids.shape + (D,)."""
    flat = ids.reshape(-1)
    rows = table[flat] if fn is None else fn(table, flat)
    return rows.reshape(*ids.shape, table.shape[1])


def _bag(fn, table, ids, combiner="mean"):
    """Multi-hot (-1 padded) bag: the ``embedding_bag`` op over the plain
    table, or the reference's take-and-masked-mean through ``fn``."""
    if fn is None:
        return C.bag_lookup(table, ids, combiner)
    rows = _lk(fn, table, ids.clamp_min(0))
    w = (ids >= 0).to(rows.dtype)[..., None]
    out = (rows * w).sum(-2)
    if combiner == "mean":
        out = out / w.sum(-2).clamp_min(1e-9)
    return out


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


def two_tower_init(generator: torch.Generator, cfg: RecsysConfig,
                   device=None) -> TwoTower:
    """Table and towers drawn from ``generator`` on its device (or
    ``device``)."""
    d = cfg.embed_dim
    table = _tables(generator, cfg, device)
    user = mlp_init(generator, (2 * d,) + tuple(cfg.tower_mlp), device)
    item = mlp_init(generator, (2 * d,) + tuple(cfg.tower_mlp), device)
    return TwoTower(cfg, table, user, item)


def two_tower_score(params: TwoTower, cfg, batch, lookup_fn=None):
    return params.score(batch, lookup_fn)


def two_tower_loss(params: TwoTower, cfg, batch, lookup_fn=None):
    """In-batch sampled softmax of each user against the batch's items.
    Under uniform in-batch sampling the logQ correction is a constant
    shift: the reference subtracts zeros, which changes no bit, so the
    port leaves it out; pass propensities to ``sampled_softmax_loss``
    when the sampler is not uniform."""
    u = params.user_embed(batch, lookup_fn)
    ids = batch["sparse_ids"]
    v = params.item_embed(ids[2][:, 0], ids[3][:, 0], lookup_fn)
    loss = C.sampled_softmax_loss(u, v)
    return loss, {"loss": loss}


# ===========================================================================
# DLRM
# ===========================================================================

class DLRM(nn.Module):
    """Bottom MLP over the dense features, one embedding per sparse
    feature, the pairwise dot interaction of the 27 vectors, top MLP."""

    def __init__(self, cfg: RecsysConfig, table: torch.Tensor, bot: MLP,
                 top: MLP):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.bot = bot
        self.top = top

    def forward(self, batch, lookup_fn=None) -> torch.Tensor:
        ids = C.globalize_ids(batch["sparse_ids"], _offsets(self.cfg))
        emb = _lk(lookup_fn, self.table, ids)               # (B, 26, D)
        bot = self.bot(batch["dense"], final_act=True)
        vecs = torch.cat([bot[:, None, :], emb], dim=1)     # (B, 27, D)
        z = C.dot_interaction(vecs)
        return self.top(torch.cat([bot, z], dim=1))[:, 0]


def dlrm_loss(params: DLRM, cfg, batch, lookup_fn=None):
    loss = C.bce_loss(params(batch, lookup_fn), batch["label"])
    return loss, {"loss": loss}


def dlrm_init(generator: torch.Generator, cfg: RecsysConfig,
              device=None) -> DLRM:
    n_f = cfg.n_sparse + 1
    n_int = n_f * (n_f - 1) // 2
    return DLRM(cfg, _tables(generator, cfg, device),
                mlp_init(generator, (cfg.n_dense,) + tuple(cfg.bot_mlp),
                         device),
                mlp_init(generator, (n_int + cfg.bot_mlp[-1],)
                         + tuple(cfg.top_mlp), device))


# ===========================================================================
# SASRec
# ===========================================================================

BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


class SASRec(nn.Module):
    """Causal self-attention blocks (pre-RMSNorm, one head group per head)
    over the item sequence; the last state scores items by a dot."""

    def __init__(self, cfg: RecsysConfig, table: torch.Tensor,
                 pos: torch.Tensor, blocks, final_ln: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.pos = nn.Parameter(pos)
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in blk.items()})
            for blk in blocks)
        self.final_ln = nn.Parameter(final_ln)

    def hidden(self, history, lookup_fn=None) -> torch.Tensor:
        """history (B, S) item ids (-1 pads) -> (B, S, D) causal states;
        a pad's input is zeroed after the positional add."""
        b, s = history.shape
        h = _lk(lookup_fn, self.table, history.clamp_min(0)) \
            + self.pos[None, :s]
        h = h * (history >= 0)[..., None]
        nh = self.cfg.n_heads
        hd = self.cfg.embed_dim // nh
        for blk in self.blocks:
            x = rms_norm(h, blk["ln1"])
            q = (x @ blk["wq"]).reshape(b, s, nh, hd)
            k = (x @ blk["wk"]).reshape(b, s, nh, hd)
            v = (x @ blk["wv"]).reshape(b, s, nh, hd)
            o = sdpa(q, k, v, causal=True).reshape(b, s, -1)
            h = h + o @ blk["wo"]
            x = rms_norm(h, blk["ln2"])
            h = h + torch.relu(x @ blk["w1"]) @ blk["w2"]
        return rms_norm(h, self.final_ln)

    def score(self, batch, lookup_fn=None) -> torch.Tensor:
        """CTR-style: the target item against the last sequence state."""
        h = self.hidden(batch["history"], lookup_fn)[:, -1]
        t = _lk(lookup_fn, self.table, batch["target"])
        return (h * t).sum(-1)

    def retrieval(self, batch, cand_items, lookup_fn=None) -> torch.Tensor:
        h = self.hidden(batch["history"], lookup_fn)[:, -1]
        v = _lk(lookup_fn, self.table, cand_items)                # (C, D)
        return (h @ v.T)[0]


N_NEG = 512                   # SASRec's shared sampled negatives


def sasrec_negatives(cfg, device, n_neg: int = N_NEG) -> torch.Tensor:
    """The fixed set of negatives SASRec's loss uses when the batch brings
    none: ``n_neg`` uniform item ids from a ``torch.Generator`` seeded 0,
    drawn anew (the same ids) on every call. The reference draws from
    ``jax.random.PRNGKey(0)`` in the same way; torch cannot give that
    stream, so the ids differ while the meaning, one fixed set, holds.
    On meta (the dry run) a CPU generator stands in: meta draws nothing."""
    meta = torch.device(device).type == "meta"
    g = torch.Generator(device="cpu" if meta else device).manual_seed(0)
    return torch.randint(0, cfg.table_vocabs[0], (n_neg,), generator=g,
                         device=device, dtype=torch.int32)


def sasrec_loss(params: SASRec, cfg, batch, lookup_fn=None,
                n_neg: int = N_NEG, neg_ids=None):
    """Next-item loss: each position's state scores the next item against
    shared sampled negatives (``neg_ids``, else ``batch["neg_ids"]``, else
    ``sasrec_negatives``); the mean over the valid next items of
    -log softmax([pos, negs])[pos]."""
    hist = batch["history"]
    h = params.hidden(hist[:, :-1], lookup_fn)              # predict shifted
    pos_ids = hist[:, 1:]
    pos_e = _lk(lookup_fn, params.table, pos_ids.clamp_min(0))
    pos_logit = (h * pos_e).sum(-1)
    if neg_ids is None:
        neg_ids = batch.get("neg_ids")
    if neg_ids is None:
        neg_ids = sasrec_negatives(cfg, hist.device, n_neg)
    neg_e = _lk(lookup_fn, params.table, neg_ids)           # (n_neg, D)
    neg_logit = torch.einsum("bsd,nd->bsn", h, neg_e)
    logits = torch.cat([pos_logit[..., None], neg_logit], dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    mask = (pos_ids >= 0).float()
    loss = -(logp[..., 0] * mask).sum() / mask.sum().clamp_min(1.0)
    return loss, {"loss": loss}


def sasrec_init(generator: torch.Generator, cfg: RecsysConfig,
                device=None) -> SASRec:
    d = cfg.embed_dim
    dev = init_device(generator, device)
    table = _tables(generator, cfg, dev)
    pos = torch.randn((cfg.seq_len, d), generator=generator,
                      device=dev) * 0.02
    blocks = []
    for _ in range(cfg.n_blocks):
        blk = {"ln1": torch.ones(d, device=dev),
               "ln2": torch.ones(d, device=dev)}
        blk.update({w: dense_init(generator, d, d, dev)
                    for w in BLOCK_WEIGHTS})
        blocks.append(blk)
    return SASRec(cfg, table, pos, blocks, torch.ones(d, device=dev))


# ===========================================================================
# DIN
# ===========================================================================
# tables: (goods_id, category_id); an item's embedding is [goods ; cate]

class DIN(nn.Module):
    """Target attention: an MLP scores each history item against the
    target (the local activation unit), the softmax of the scores pools
    the history, and a top MLP scores [pooled, target, pooled * target]."""

    def __init__(self, cfg: RecsysConfig, table: torch.Tensor, attn: MLP,
                 top: MLP):
        super().__init__()
        self.cfg = cfg
        self.table = nn.Parameter(table)
        self.attn = attn
        self.top = top

    def item_emb(self, goods_ids, lookup_fn=None) -> torch.Tensor:
        """[goods ; category] rows; an item's category is goods % V_cate;
        -1 pads read item 0 (the caller masks them)."""
        off = _offsets(self.cfg)
        goods = goods_ids.clamp_min(0)
        cate = goods % self.cfg.table_vocabs[1]
        g = _lk(lookup_fn, self.table, goods + int(off[0]))
        c = _lk(lookup_fn, self.table, cate + int(off[1]))
        return torch.cat([g, c], dim=-1)

    def pooled(self, history, hist_len, target_e,
               lookup_fn=None) -> torch.Tensor:
        """Local activation unit -> softmax-weighted sum of the history's
        first hist_len valid items."""
        h_e = self.item_emb(history, lookup_fn)               # (B, S, 2d)
        t_e = target_e[:, None, :].expand_as(h_e)
        feat = torch.cat([t_e, h_e, t_e - h_e, t_e * h_e], dim=-1)
        a = self.attn(feat)[..., 0]                           # (B, S)
        s = history.shape[1]
        mask = (torch.arange(s, device=history.device)[None, :]
                < hist_len[:, None])
        a = torch.where(mask & (history >= 0), a, -1e30)
        w = torch.softmax(a, dim=1)
        return torch.einsum("bs,bsd->bd", w, h_e)

    def _head(self, pooled, t_e):
        x = torch.cat([pooled, t_e, pooled * t_e], dim=-1)
        return self.top(x)[:, 0]

    def forward(self, batch, lookup_fn=None) -> torch.Tensor:
        t_e = self.item_emb(batch["target"], lookup_fn)
        pooled = self.pooled(batch["history"], batch["history_len"], t_e,
                             lookup_fn)
        return self._head(pooled, t_e)

    def retrieval(self, batch, cand_items, lookup_fn=None) -> torch.Tensor:
        """1 user x C candidate targets: each candidate re-attends the
        user's history."""
        c = cand_items.shape[0]
        t_e = self.item_emb(cand_items, lookup_fn)            # (C, 2d)
        hist = batch["history"][0][None].expand(c, -1)
        hl = batch["history_len"][0].expand(c)
        return self._head(self.pooled(hist, hl, t_e, lookup_fn), t_e)


def din_loss(params: DIN, cfg, batch, lookup_fn=None):
    loss = C.bce_loss(params(batch, lookup_fn), batch["label"])
    return loss, {"loss": loss}


def din_init(generator: torch.Generator, cfg: RecsysConfig,
             device=None) -> DIN:
    d2 = 2 * cfg.embed_dim
    return DIN(cfg, _tables(generator, cfg, device),
               mlp_init(generator, (4 * d2,) + tuple(cfg.attn_mlp) + (1,),
                        device),
               mlp_init(generator, (3 * d2,) + tuple(cfg.top_mlp) + (1,),
                        device))


# ===========================================================================
# dispatch
# ===========================================================================

INIT = {"dlrm-mlperf": dlrm_init, "two-tower-retrieval": two_tower_init,
        "sasrec": sasrec_init, "din": din_init}
LOSS = {"dlrm-mlperf": dlrm_loss, "two-tower-retrieval": two_tower_loss,
        "sasrec": sasrec_loss, "din": din_loss}
SCORE = {"dlrm-mlperf": lambda p, c, b, f=None: p(b, f),
         "two-tower-retrieval": two_tower_score,
         "sasrec": lambda p, c, b, f=None: p.score(b, f),
         "din": lambda p, c, b, f=None: p(b, f)}


def family_of(cfg: RecsysConfig) -> str:
    name = cfg.name.replace("-smoke", "")
    for k in INIT:
        if name.startswith(k.split("-")[0]):
            return k
    raise KeyError(cfg.name)
