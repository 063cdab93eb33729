"""Decoder-only TransformerLM of the port (the reference's
``models/transformer.py``): the dense GQA decoders (qwen2-1.5b,
mistral-nemo-12b, qwen3-32b), the MoE deepseek-moe-16b and the MLA + MoE
deepseek-v2-236b.

    model = init_params(generator, cfg)        # an nn.Module
    logits, aux = forward(model, cfg, tokens)  # train / eval, (B, S, V) f32
    loss, metrics = lm_loss(model, cfg, batch)
    logits, cache = prefill(model, cfg, tokens, max_len=None)
    logits, cache = decode_step(model, cfg, token, cache, pos)

Each entry point also takes a ``mesh=``: the tensor- and expert-parallel
programs over a ``sharding.ShardedLM`` (the section at the end of this
file); without one, nothing changes.

The reference stacks its layers into one pytree and scans over it, with
an MoE config's leading dense layers (``first_dense_layers``, a SwiGLU of
width ``dense_d_ff``) unrolled ahead of the stack as ``dense_layers``. The
port holds one block module per layer, the dense ones first
(``model.blocks[i]``: its ``ln1`` / ``ln2``, ``attn`` (GQA or MLA) and
either ``ffn`` or ``moe``, under the reference's names) and loops.
``forward`` sums the MoE layers' aux losses, and ``lm_loss`` adds
``router_aux_loss`` times that sum. ``forward(remat=True)`` recomputes each
block in the backward pass (``torch.utils.checkpoint``), as
``jax.checkpoint`` does; it changes no number. Tied embeddings
(qwen2-1.5b) use ``embed.T`` as the head. Weights are in the config's type
(bf16 at full width); norms, rope and softmax run in float32 exactly where
the reference casts, and the logits come out in float32.

The KV cache is written in place. GQA caches k / v (Lyr, B, Smax, KV,
hd); MLA caches its latent c_kv (Lyr, B, Smax, r) and the roped shared key
(Lyr, B, Smax, rd), and decodes in the absorbed form
(``layers.mla_decode_absorbed``). The reference returns new arrays from
every step, and its ``prefill`` stacks the layers' caches and pads them to
``max_len``; at full width a copy of the cache is tens of GB (qwen2-1.5b
at B = 64 x 32k: 60 GB). So ``prefill`` writes each layer's entries into a
cache from ``init_cache``, and ``decode_step`` writes into the cache it is
given and returns that same cache with the new lengths: a caller that
wants the old cache keeps a clone. A decode write at a position past the
cache is dropped, as JAX drops an out-of-bounds scatter update (the
reference decodes at ``pos == S`` after a prefill without ``max_len``).
Both run under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import flags
from repro_torch.analysis import op_costs
from repro_torch.configs.base import LMConfig
from repro_torch.core.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models.moe import MeshRouting, MoE, moe_apply, \
    moe_apply_tp, moe_init


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn`` (GQA or MLA), ``ln2``, and
    either a SwiGLU ``ffn`` or an ``moe``."""

    def __init__(self, ln1: torch.Tensor, ln2: torch.Tensor,
                 attn: nn.ParameterDict,
                 ffn: Optional[nn.ParameterDict] = None,
                 moe: Optional[MoE] = None):
        super().__init__()
        if (ffn is None) == (moe is None):
            raise ValueError("a block has either an ffn or an moe")
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.attn = attn
        self.ffn = ffn
        self.moe = moe


class TransformerLM(nn.Module):
    def __init__(self, cfg: LMConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, blocks,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.blocks = nn.ModuleList(blocks)
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)

    def head(self) -> torch.Tensor:
        """(d, V): the LM head, or ``embed.T`` when the embeddings are tied."""
        return self.embed.T if self.lm_head is None else self.lm_head


# ---------------------------------------------------------------- init
def init_params(generator: torch.Generator, cfg: LMConfig,
                device=None) -> TransformerLM:
    """The reference's init recipe on the generator's device: embed
    N(0, 0.02^2), unit norms, ``gqa_init`` or ``mla_init`` per layer, then
    ``swiglu_init`` (width ``dense_d_ff`` in an MoE config's leading dense
    layers) or ``moe_init``, an untied head N(0, 1/d). Each tensor is
    drawn in float32 and cast to the config's type before the next is
    drawn, so the largest temporary is one float32 tensor (qwen3-32b's
    embed: 3.1 GB; deepseek-v2-236b's stacked experts: 5.0 GB).
    ``device="meta"`` builds the model shape-only, drawing nothing."""
    dt = L.lm_dtype(cfg)
    dev = L.init_device(generator, device)
    d, v = cfg.d_model, cfg.vocab_size
    width = cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev)
                * scale).to(dt)

    def block(i):
        attn = L.mla_init(generator, cfg, dev) if cfg.use_mla \
            else L.gqa_init(generator, cfg, dev)
        ones = [torch.ones((d,), dtype=dt, device=dev) for _ in range(2)]
        if cfg.moe and i >= cfg.first_dense_layers:
            return Block(*ones, attn, moe=moe_init(generator, cfg, dev))
        return Block(*ones, attn,
                     ffn=L.swiglu_init(generator, d, width, dt, dev))

    embed = normal((v, d), 0.02)
    blocks = [block(i) for i in range(cfg.n_layers)]
    head = None if cfg.tie_embeddings else normal((d, v), d ** -0.5)
    return TransformerLM(cfg, embed, torch.ones((d,), dtype=dt, device=dev),
                         blocks, head)


# ---------------------------------------------------------------- forward
def _ffn(blk: Block, cfg: LMConfig, h):
    """The block's FFN on h -> (out, aux loss: 0 for a dense block)."""
    if blk.moe is not None:
        return moe_apply(blk.moe, cfg, h)
    return L.swiglu_apply(blk.ffn, h), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def _block(blk: Block, cfg: LMConfig, x, positions):
    h = L.rms_norm(x, blk.ln1, cfg.rms_eps)
    attend = L.mla_apply if cfg.use_mla else L.gqa_apply
    x = x + attend(blk.attn, cfg, h, positions)
    h, aux = _ffn(blk, cfg, L.rms_norm(x, blk.ln2, cfg.rms_eps))
    return x + h, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def logits_of(model, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Final-normed states (..., d) -> float32 logits (..., V). With a
    ``mesh`` (``model`` a ``ShardedLM``): each batch group's rows through
    the vocabulary-parallel head, gathered over ``model``."""
    if mesh is not None:
        return _tp_over_groups(mesh, x, lambda grp, x_: _tp_full_logits(
            model, grp, x_))
    return (x @ model.head()).float()


def forward(model, cfg: LMConfig, tokens: torch.Tensor,
            remat: bool = True, mesh=None):
    """tokens (B, S) -> (logits (B, S, V) float32, the MoE layers' summed
    aux loss: 0 for a dense model). With ``remat`` and autograd on, each
    block is recomputed in the backward pass. With a ``mesh`` (``model`` a
    ``ShardedLM``), each batch group runs its tensor-parallel program
    (module docstring)."""
    if mesh is not None:
        x, aux = _tp_forward(model, cfg, tokens, remat, mesh)
        return logits_of(model, x, mesh), aux
    b, s = tokens.shape
    x = model.embed[tokens]
    positions = _positions(b, s, tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in model.blocks:
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block, blk, cfg, x, positions,
                                use_reentrant=False)
        else:
            x, aux = _block(blk, cfg, x, positions)
        aux_total = aux_total + aux
    x = L.rms_norm(x, model.final_norm, cfg.rms_eps)
    return logits_of(model, x), aux_total


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits, (B, S) labels -> (B, S) NLL under the branch
    ``flags.SHARDED_CE`` picks (``lm_loss``)."""
    labels = labels.long()[..., None]
    if flags.SHARDED_CE:
        m = logits.amax(-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
        onehot = torch.zeros_like(logits).scatter_(-1, labels, 1.0)
        return lse - (logits * onehot).sum(-1)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels)[..., 0]


def _masked_mean(nll: torch.Tensor) -> torch.Tensor:
    """The mean over every position but each row's last."""
    mask = torch.ones_like(nll)
    mask[:, -1] = 0.0
    return (nll * mask).sum() / mask.sum()


def lm_loss(model, cfg: LMConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True, mesh=None):
    """Mean next-token NLL over every position but the last (its label
    wraps around), plus the router's aux term; metrics loss, aux, ppl.
    ``flags.SHARDED_CE`` (read now) takes the NLL as max + log-sum-exp
    minus the label's logit picked by a one-hot product, as the
    reference's vocab-sharding-safe branch; otherwise log_softmax and a
    gather. With a ``mesh``: each batch group's mean from its
    tensor-parallel program (the vocabulary-parallel head's logits
    gathered over ``model``, or, under ``SHARDED_CE``, reduced as their
    max, sum of exponentials and the label's logit), averaged over the
    groups."""
    if mesh is not None:
        loss, aux = _tp_loss(model, cfg, batch, remat, mesh)
    else:
        logits, aux = forward(model, cfg, batch["tokens"], remat=remat)
        loss = _masked_mean(_nll(logits, batch["labels"]))
    total = loss + cfg.router_aux_loss * aux
    return total, {"loss": loss, "aux": aux, "ppl": torch.exp(loss)}


# ---------------------------------------------------------------- serving
class KVCache(NamedTuple):
    """Stacked per-layer caches in the config's type: GQA k / v (Lyr, B,
    Smax, KV, hd); MLA c_kv (Lyr, B, Smax, r) and k_rope (Lyr, B, Smax,
    rd). And the (B,) valid lengths."""
    a: torch.Tensor
    b: torch.Tensor
    length: torch.Tensor


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device=None) -> KVCache:
    """A zero cache on ``device`` (default: the card)."""
    dev = resolve_device(device)
    dt = L.lm_dtype(cfg)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.use_mla:
        a = torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dt, device=dev)
        b = torch.zeros(lead + (cfg.qk_rope_head_dim,), dtype=dt,
                        device=dev)
    else:
        a = torch.zeros(lead + (cfg.n_kv_heads, cfg.head_dim), dtype=dt,
                        device=dev)
        b = torch.zeros_like(a)
    return KVCache(a=a, b=b, length=torch.zeros((batch,), dtype=torch.int32,
                                                device=dev))


@torch.no_grad()
def prefill_states(model, cfg: LMConfig, tokens: torch.Tensor,
                   max_len: Optional[int] = None, mesh=None):
    """One causal pass over tokens (B, S) -> (final-normed states (B, S,
    d), a cache of ``max_len`` (default S) positions holding each layer's
    k / v (MLA: c_kv / k_rope) for the S tokens, lengths S). With a
    ``mesh``: the tensor-parallel program per batch group, into a
    ``ShardedKVCache``."""
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt "
                         f"({s} tokens)")
    if mesh is not None:
        return _tp_prefill(model, cfg, tokens, max_len, mesh)
    cache = init_cache(cfg, b, max_len, tokens.device)
    x = model.embed[tokens]
    positions = _positions(b, s, tokens.device)
    for i, blk in enumerate(model.blocks):
        h = L.rms_norm(x, blk.ln1, cfg.rms_eps)
        if cfg.use_mla:
            c_kv, k_rope = L._mla_latent(blk.attn, cfg, h, positions)
            cache.a[i, :, :s] = c_kv
            cache.b[i, :, :s] = k_rope
            q = L._mla_q(blk.attn, cfg, h, positions)
            k, v = L._mla_kv_from_latent(blk.attn, cfg, c_kv, k_rope)
            del c_kv, k_rope
            o = L.mla_attend(q, k, v, causal=True)
        else:
            q, k, v = L.gqa_qkv(blk.attn, cfg, h, positions)
            cache.a[i, :, :s] = k
            cache.b[i, :, :s] = v
            o = L.attention(q, k, v, causal=True)
        del q, k, v, h
        x = x + o.reshape(b, s, -1) @ blk.attn["wo"]
        del o
        x = x + _ffn(blk, cfg, L.rms_norm(x, blk.ln2, cfg.rms_eps))[0]
    cache.length.fill_(s)
    return L.rms_norm(x, model.final_norm, cfg.rms_eps), cache


def prefill(model, cfg: LMConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, mesh=None):
    """tokens (B, S) -> (logits (B, S, V) float32, populated KVCache)."""
    x, cache = prefill_states(model, cfg, tokens, max_len, mesh)
    with torch.no_grad():
        return logits_of(model, x, mesh), cache


@torch.no_grad()
def decode_step(model, cfg: LMConfig, token: torch.Tensor, cache,
                pos: torch.Tensor, mesh=None):
    """token (B,), pos (B,) absolute position -> (logits (B, V) float32,
    the same cache written at ``pos`` with lengths ``pos + 1``). With a
    ``mesh``: the tensor-parallel step per batch group on a
    ``ShardedKVCache``."""
    if mesh is not None:
        return _tp_decode(model, cfg, token, cache, pos, mesh)
    x = model.embed[token][:, None, :]                       # (B, 1, d)
    kv_valid = pos + 1
    attend = L.mla_decode_absorbed if cfg.use_mla else L.gqa_decode
    for i, blk in enumerate(model.blocks):
        h = L.rms_norm(x, blk.ln1, cfg.rms_eps)
        h, _ = attend(blk.attn, cfg, h, pos, (cache.a[i], cache.b[i]),
                      kv_valid)
        x = x + h
        x = x + _ffn(blk, cfg, L.rms_norm(x, blk.ln2, cfg.rms_eps))[0]
    x = L.rms_norm(x, model.final_norm, cfg.rms_eps)
    return logits_of(model, x[:, 0]), KVCache(a=cache.a, b=cache.b,
                                              length=kv_valid)


# ------------------------------------------------------ tensor parallel
# The LM over a mesh (``mesh=`` above): ``model`` is a ``sharding.ShardedLM``.
# Each batch group (the batch split over the data axes where it divides,
# ``sharding.batch_seq_spec``) runs one program over its ``model`` shards: the
# vocabulary-parallel lookup (each shard its own rows, an all-reduce), per
# block the replicated norms and residual adds, attention
# (``layers.gqa_apply_tp`` / ``mla_apply_tp``: head-TP under
# ``flags.HEAD_TP_ATTENTION`` when the heads divide, else sequence-parallel, as
# the reference's ``chunked_sdpa`` places q), the SwiGLU (column- then
# row-parallel) or the MoE layer (``moe.moe_apply_tp``: its experts over
# ``model``), and the vocabulary-parallel head. Each block runs the splits the
# rules give its own weights (``_splits``): an MoE config's leading dense block
# matches the stacked layers' rules cut to its rank, so its projections and FFN
# run replicated and only ``wo`` / ``w_down`` split, on their output columns
# (its attention still splits by heads or rows, from the replicated q / k / v).
# A block is recomputed in the backward pass under ``remat``. The groups share
# a ``moe.MeshRouting``: the MoE layers' dispatch layout and aux loss span
# every group's tokens. On a meta mesh the first group's program stands in for
# every group's.

def _tp_over_groups(mesh, x: torch.Tensor, fn,
                    book: Optional[MeshRouting] = None) -> torch.Tensor:
    """``fn(group, rows)`` over each batch group's rows of ``x`` (axis 0),
    the results joined on axis 0 on the mesh's first device: every group
    where the batch divides over the data axes, else group 0 over all of
    it (every group computes the same). ``book``: told how many groups
    the rows split over; its routing log is written once they ran."""
    n = SH.columns(mesh).shape[0]
    if SH.batch_seq_spec(mesh, x.shape)[0] is None:
        n = 1
    if book is not None:
        book.parts = n
    parts = x.split(x.shape[0] // n)
    run = 1 if SH.on_meta(mesh) else n
    outs = []
    for g in range(run):
        grp = TP.Group(mesh, g)
        outs.append(fn(grp, parts[g].to(grp.home)))
    if book is not None:
        book.flush_log()
    home = mesh.devices.reshape(-1)[0]
    if run < n:
        return op_costs.stand_in(outs[0], n, dim=0)
    if n == 1:
        return outs[0]
    with op_costs.suspended():
        return torch.cat([o.to(home) for o in outs])


def _split_of(model, names, last: str) -> str:
    """"tp" where every weight of ``names`` splits on its columns and
    ``last`` on its rows, "cols" where only ``last`` splits, on its
    output columns, "rep" where none does."""
    d_last = model.dims[last]
    if d_last == 0 and all(model.dims[n] == 1 for n in names):
        return "tp"
    if d_last in (None, 1) and not any(model.split(n) for n in names):
        return "cols" if d_last == 1 else "rep"
    raise ValueError(f"{last}: no program for the split "
                     f"{[model.dims[n] for n in names + [last]]}")


def _splits(model, cfg: LMConfig, i: int):
    """Block i's (attention split, FFN split, routed experts split):
    ``_split_of`` on its weights; the FFN's is its shared experts' in an
    MoE block, whose routed experts split on their expert axis (True) or
    are replicated."""
    a = f"blocks.{i}.attn."
    if cfg.use_mla:
        ins = ["wq_b" if cfg.q_lora_rank else "wq", "wkv_b"]
    else:
        ins = ["wq", "wk", "wv"]
    attn = _split_of(model, [a + w for w in ins], a + "wo")
    moe = model.shards[0].blocks[i].moe
    f = f"blocks.{i}.moe.shared." if moe is not None else f"blocks.{i}.ffn."
    if moe is not None and moe.shared is None:
        ffn = "rep"
    else:
        ffn = _split_of(model, [f + "w_gate", f + "w_up"], f + "w_down")
    experts = moe is not None and model.split(f"blocks.{i}.moe.w_gate")
    return attn, ffn, experts


def _tp_mode(model, cfg: LMConfig, mesh, s: int, i: int) -> str:
    """How the groups run block i's attention over ``model``
    (``gqa_apply_tp``): "rep" where its weights are replicated, else by
    heads or by rows as the reference's ``chunked_sdpa`` places q (also
    where only ``wo`` splits: the placement is the activations')."""
    split = _splits(model, cfg, i)[0]
    if split == "rep":
        return "rep"
    n = SH.model_size(mesh)
    if flags.HEAD_TP_ATTENTION and cfg.n_heads % n == 0:
        return "heads"
    if SH.batch_seq_spec(mesh, (1, s), 0, 1)[1] == "model":
        return "seq"
    if cfg.n_heads % n == 0:
        return "heads"
    raise ValueError(f"{s} positions and {cfg.n_heads} heads: neither "
                     f"splits over {n} shards")


def _tp_embed(model, grp, tokens: torch.Tensor) -> torch.Tensor:
    """Vocabulary-parallel lookup: each shard its own rows' ids, zeros for
    the rest, summed (exactly) by an all-reduce."""
    if not model.split("embed"):
        return grp.local(lambda e: e[tokens], model.shards[0].embed)
    toks = TP.replicate(grp, tokens)

    def look(i, table, ids):
        n = table.shape[0]
        local = ids.long() - i * n
        keep = (local >= 0) & (local < n)
        rows = table[torch.where(keep, local, torch.zeros_like(local))]
        return rows * keep[..., None].to(rows.dtype)
    return TP.all_reduce(grp, [grp.run(i, look, i, model.shards[i].embed,
                                       toks[k]) for k, i in
                               enumerate(grp.shards)])


def _tp_attend(model, cfg, grp, i: int, h, positions, mode: str):
    """Block i's attention on h -> (output, the cache's entries: each
    running shard's (K, V), or the MLA latent (c_kv, k_rope))."""
    attns = [m.blocks[i].attn for m in model.shards]
    apply = L.mla_apply_tp if cfg.use_mla else L.gqa_apply_tp
    return apply(grp, attns, cfg, h, positions, mode,
                 _splits(model, cfg, i)[0])


def _tp_ffn(model, cfg, grp, i: int, h, book: MeshRouting):
    """Block i's FFN or MoE layer on h -> (out, None or the MoE layer's
    (pair counts, probability sums))."""
    _, ffn, experts = _splits(model, cfg, i)
    blks = [m.blocks[i] for m in model.shards]
    if blks[0].moe is None:
        return L.swiglu_apply_tp(grp, [b.ffn for b in blks], h, ffn), None
    out, counts, psum = moe_apply_tp(grp, [b.moe for b in blks], cfg, h,
                                     book, i, experts, ffn)
    return out, (counts, psum)


def _tp_block(model, cfg: LMConfig, grp, i: int, x, positions, mode: str,
              book: MeshRouting):
    ln1, ln2 = model.shards[0].blocks[i].ln1, model.shards[0].blocks[i].ln2
    h = grp.local(L.rms_norm, x, ln1, cfg.rms_eps)
    a, _ = _tp_attend(model, cfg, grp, i, h, positions, mode)
    x = grp.local(torch.add, x, a)
    h = grp.local(L.rms_norm, x, ln2, cfg.rms_eps)
    f, stats = _tp_ffn(model, cfg, grp, i, h, book)
    return grp.local(torch.add, x, f), stats


def _tp_states(model, cfg: LMConfig, grp, tokens, remat: bool,
               book: MeshRouting):
    """One group's tokens (B, S) -> its final-normed states (B, S, d)."""
    b, s = tokens.shape
    x = _tp_embed(model, grp, tokens)
    positions = _positions(b, s, grp.home)
    for i in range(cfg.n_layers):
        mode = _tp_mode(model, cfg, grp.mesh, s, i)
        if remat and torch.is_grad_enabled():
            x, stats = checkpoint(_tp_block, model, cfg, grp, i, x,
                                  positions, mode, book, use_reentrant=False)
        else:
            x, stats = _tp_block(model, cfg, grp, i, x, positions, mode,
                                 book)
        if stats is not None:
            book.stats.setdefault(i, {})[book.part(grp)] = stats
    return grp.local(L.rms_norm, x, model.shards[0].final_norm,
                     cfg.rms_eps)


def _tp_forward(model, cfg: LMConfig, tokens, remat: bool, mesh):
    """The groups' final-normed states (B, S, d) and the summed aux
    loss."""
    book = MeshRouting(mesh)
    x = _tp_over_groups(mesh, tokens, lambda grp, t: _tp_states(
        model, cfg, grp, t, remat, book), book)
    return x, book.aux_loss(cfg)


def _tp_head(model, grp, x):
    """Each running shard's float32 logits over its vocabulary columns
    (the head's input fanned out), or None where the head is
    replicated."""
    name = "embed" if model.cfg.tie_embeddings else "lm_head"
    if not model.split(name):
        return None
    xs = TP.fan_out(grp, x)
    return [grp.run(i, logits_of, model.shards[i], xs[k])
            for k, i in enumerate(grp.shards)]


def _tp_full_logits(model, grp, x) -> torch.Tensor:
    parts = _tp_head(model, grp, x)
    if parts is None:
        return grp.local(logits_of, model.shards[0], x)
    return TP.all_gather(grp, parts, -1)


def _tp_nll(model, grp, x, labels) -> torch.Tensor:
    """One group's (B, S) NLL: the head's logits gathered, or under
    ``SHARDED_CE`` reduced over the shards (the max, the sum of
    exponentials and the label's logit, each an all-reduce of (B, S))."""
    parts = _tp_head(model, grp, x)
    if parts is None or not flags.SHARDED_CE:
        logits = grp.local(logits_of, model.shards[0], x) if parts is None \
            else TP.all_gather(grp, parts, -1)
        return grp.local(_nll, logits, labels)
    run = list(enumerate(grp.shards))
    labs = TP.replicate(grp, labels)
    m = TP.all_reduce_max(grp, [grp.run(i, torch.amax, parts[k], -1)
                                for k, i in run])
    ms = TP.replicate(grp, m)
    se = TP.all_reduce(grp, [grp.run(
        i, lambda lg, m_: torch.exp(lg - m_[..., None]).sum(-1), parts[k],
        ms[k]) for k, i in run])

    def pick(i, lg, lab):
        v = lg.shape[-1]
        local = lab.long() - i * v
        keep = (local >= 0) & (local < v)
        idx = torch.where(keep, local, torch.zeros_like(local))[..., None]
        onehot = torch.zeros_like(lg).scatter_(-1, idx,
                                               keep[..., None].to(lg.dtype))
        return (lg * onehot).sum(-1)
    lab = TP.all_reduce(grp, [grp.run(i, pick, i, parts[k], labs[k])
                              for k, i in run])
    return grp.local(lambda m_, se_, lab_: m_ + torch.log(se_) - lab_, m,
                     se, lab)


def _tp_loss(model, cfg: LMConfig, batch, remat: bool, mesh):
    """(The mean of the groups' losses (equal row counts), the groups'
    scalars all-reduced over the data axes; the summed aux loss)."""
    both = torch.stack([batch["tokens"], batch["labels"].to(
        batch["tokens"].dtype)], dim=-1)
    book = MeshRouting(mesh)

    def group_loss(grp, tl):
        x = _tp_states(model, cfg, grp, tl[..., 0], remat, book)
        return grp.local(_masked_mean, _tp_nll(model, grp, x, tl[..., 1]))[
            None]
    losses = _tp_over_groups(mesh, both, group_loss, book)
    op_costs.record_collective("all-reduce", 4, SH.axes_size(
        mesh, SH.batch_axes(mesh)) if losses.shape[0] > 1 else 1)
    return losses.mean(), book.aux_loss(cfg)


def _tp_prefill(model, cfg: LMConfig, tokens, max_len: int, mesh):
    b, s = tokens.shape
    cache = SH.init_sharded_cache(cfg, mesh, b, max_len,
                                  model.shards[0].embed.dtype)
    split = SH.cache_split(cfg, mesh)
    book = MeshRouting(mesh)

    def group(grp, t):
        blocks = cache.blocks[grp.g]
        x = _tp_embed(model, grp, t)
        positions = _positions(t.shape[0], s, grp.home)
        for i in range(cfg.n_layers):
            ln1 = model.shards[0].blocks[i].ln1
            ln2 = model.shards[0].blocks[i].ln2
            h = grp.local(L.rms_norm, x, ln1, cfg.rms_eps)
            a, kvs = _tp_attend(model, cfg, grp, i, h, positions,
                                _tp_mode(model, cfg, mesh, s, i))
            if cfg.use_mla:                   # the latent, replicated
                kvs = list(zip(*(TP.replicate(grp, t_) for t_ in kvs)))
            for k, j in enumerate(grp.shards):
                grp.run(j, _write_prefill, cfg, blocks[j], i, kvs[k], j,
                        grp.size, split, s)
            x = grp.local(torch.add, x, a)
            h = grp.local(L.rms_norm, x, ln2, cfg.rms_eps)
            x = grp.local(torch.add, x, _tp_ffn(model, cfg, grp, i, h,
                                                book)[0])
        return grp.local(L.rms_norm, x, model.shards[0].final_norm,
                         cfg.rms_eps)
    x = _tp_over_groups(mesh, tokens, group, book)
    cache.length.fill_(s)
    return x, cache


def _write_prefill(cfg, block, i: int, kv, j: int, n: int, split: str,
                   s: int) -> None:
    """Shard j's part of layer i's K / V (or MLA latent) for the prompt's
    s positions into its cache block: its KV heads ("heads"), or the
    prompt positions its block of the sequence holds ("seq")."""
    (ca, cb), (k, v) = block, kv
    if split == "heads":
        if k.shape[2] == cfg.n_kv_heads:            # it holds all heads
            w = cfg.n_kv_heads // n
            k, v = k.narrow(2, j * w, w), v.narrow(2, j * w, w)
        ca[i, :, :s] = k
        cb[i, :, :s] = v
        return
    size = ca.shape[2]
    lo, hi = j * size, min(s, (j + 1) * size)
    if hi > lo:
        ca[i, :, :hi - lo] = k[:, lo:hi]
        cb[i, :, :hi - lo] = v[:, lo:hi]


def _tp_decode_attn(model, cfg: LMConfig, grp, i: int, h, pos, caches,
                    kv_valid, split: str):
    """Block i's decode attention (``layers.gqa_decode_tp`` on a cache
    split as ``split`` says, or ``mla_decode_tp``)."""
    attns = [m.blocks[i].attn for m in model.shards]
    mode = _splits(model, cfg, i)[0]
    if cfg.use_mla:
        return L.mla_decode_tp(grp, attns, cfg, h, pos, caches, kv_valid,
                               mode)
    return L.gqa_decode_tp(grp, attns, cfg, h, pos, caches, kv_valid, split,
                           mode)


def _tp_decode(model, cfg: LMConfig, token, cache, pos, mesh):
    split = SH.cache_split(cfg, mesh)
    both = torch.stack([token.to(pos.dtype), pos], dim=-1)
    book = MeshRouting(mesh)

    def group(grp, tp_):
        tok, p = tp_[:, 0], tp_[:, 1]
        blocks = cache.blocks[grp.g]
        kv_valid = p + 1
        x = _tp_embed(model, grp, tok[:, None])
        for i in range(cfg.n_layers):
            blk = model.shards[0].blocks[i]
            h = grp.local(L.rms_norm, x, blk.ln1, cfg.rms_eps)
            caches = [(blocks[j][0][i], blocks[j][1][i]) for j in grp.shards]
            x = grp.local(torch.add, x, _tp_decode_attn(
                model, cfg, grp, i, h, p, caches, kv_valid, split))
            h = grp.local(L.rms_norm, x, blk.ln2, cfg.rms_eps)
            x = grp.local(torch.add, x, _tp_ffn(model, cfg, grp, i, h,
                                                book)[0])
        x = grp.local(L.rms_norm, x, model.shards[0].final_norm,
                      cfg.rms_eps)
        return _tp_full_logits(model, grp, x[:, 0])
    logits = _tp_over_groups(mesh, both, group, book)
    return logits, cache._replace(length=(pos + 1).to(cache.length.device))
