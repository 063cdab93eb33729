"""Decoder-only TransformerLM of the port (the reference's
``models/transformer.py``): the dense GQA decoders (qwen2-1.5b,
mistral-nemo-12b, qwen3-32b), the MoE deepseek-moe-16b and the MLA + MoE
deepseek-v2-236b.

    model = init_params(generator, cfg)        # an nn.Module
    logits, aux = forward(model, cfg, tokens)  # train / eval, (B, S, V) f32
    loss, metrics = lm_loss(model, cfg, batch)
    logits, cache = prefill(model, cfg, tokens, max_len=None)
    logits, cache = decode_step(model, cfg, token, cache, pos)

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
from repro_torch.configs.base import LMConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, moe_apply, moe_init


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


def logits_of(model: TransformerLM, x: torch.Tensor) -> torch.Tensor:
    """Final-normed states (..., d) -> float32 logits (..., V)."""
    return (x @ model.head()).float()


def forward(model: TransformerLM, cfg: LMConfig, tokens: torch.Tensor,
            remat: bool = True):
    """tokens (B, S) -> (logits (B, S, V) float32, the MoE layers' summed
    aux loss: 0 for a dense model). With ``remat`` and autograd on, each
    block is recomputed in the backward pass."""
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


def lm_loss(model: TransformerLM, cfg: LMConfig,
            batch: Dict[str, torch.Tensor], remat: bool = True):
    """Mean next-token NLL over every position but the last (its label
    wraps around), plus the router's aux term; metrics loss, aux, ppl.
    ``flags.SHARDED_CE`` (read now) takes the NLL as max + log-sum-exp
    minus the label's logit picked by a one-hot product, as the
    reference's vocab-sharding-safe branch; otherwise log_softmax and a
    gather."""
    logits, aux = forward(model, cfg, batch["tokens"], remat=remat)
    labels = batch["labels"].long()[..., None]
    if flags.SHARDED_CE:
        m = logits.amax(-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
        onehot = torch.zeros_like(logits).scatter_(-1, labels, 1.0)
        nll = lse - (logits * onehot).sum(-1)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels)[..., 0]
    mask = torch.ones_like(nll)
    mask[:, -1] = 0.0
    loss = (nll * mask).sum() / mask.sum()
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
def prefill_states(model: TransformerLM, cfg: LMConfig, tokens: torch.Tensor,
                   max_len: Optional[int] = None):
    """One causal pass over tokens (B, S) -> (final-normed states (B, S,
    d), a cache of ``max_len`` (default S) positions holding each layer's
    k / v (MLA: c_kv / k_rope) for the S tokens, lengths S)."""
    b, s = tokens.shape
    max_len = max_len or s
    if max_len < s:
        raise ValueError(f"max_len {max_len} is shorter than the prompt "
                         f"({s} tokens)")
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


def prefill(model: TransformerLM, cfg: LMConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None):
    """tokens (B, S) -> (logits (B, S, V) float32, populated KVCache)."""
    x, cache = prefill_states(model, cfg, tokens, max_len)
    with torch.no_grad():
        return logits_of(model, x), cache


@torch.no_grad()
def decode_step(model: TransformerLM, cfg: LMConfig, token: torch.Tensor,
                cache: KVCache, pos: torch.Tensor):
    """token (B,), pos (B,) absolute position -> (logits (B, V) float32,
    the same cache written at ``pos`` with lengths ``pos + 1``)."""
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
