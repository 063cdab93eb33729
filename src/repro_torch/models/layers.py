"""Dense building blocks of the recsys models and the dense LM (the
reference's ``models/layers.py``): ``dense_init``, ``mlp_init`` /
``mlp_apply``, ``rms_norm``, rotary embeddings (``rope_cache`` /
``apply_rope``), attention (``sdpa``, ``chunked_sdpa``, ``attention``),
grouped-query attention with QKV bias and per-head qk-norm (``gqa_*``),
DeepSeek-V2's multi-head latent attention (``mla_*``) and the SwiGLU FFN
(``swiglu_*``).

The arithmetic is the reference's: weights are stored (in, out), a layer is
``x @ w`` and then ``+ b`` as a separate op, with ReLU between layers. Not
``nn.Linear``/``addmm``: fusing the bias into the product would round
differently, and the (in, out) layout carries the reference's weights
without a transpose. ``sdpa`` is the reference's einsum attention in plain
tensor ops (GQA head groups, f32 softmax, the -1e30 mask): it is no Pallas
kernel there either, and the plain ops keep its arithmetic for the parity
tests. So is ``chunked_sdpa``, the reference's flash-style loop over KV
blocks with an online softmax; each keeps the reference's own order of
operations (``sdpa`` divides the scores by sqrt(hd) after the product,
``chunked_sdpa`` scales q first), and both upcast q, k and v to float32
as the reference does.

The LM's weights are ``bf16`` in the full configs (float32 in the smoke
ones); norms, rope and softmax run in float32 and cast back exactly where
the reference casts. A layer's parameters live in an ``nn.ParameterDict``
under the reference's names (``wq``, ``bq``, ``q_norm``, ``w_gate``...),
so ``p["wq"]`` reads as the reference's ``p["wq"]``.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as TP

MASKED = -1e30        # the reference's masked score (not -inf: no NaN rows)


def init_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an init puts its tensors: ``device``, else the generator's.
    A CPU generator with ``device="meta"`` gives shape-only parameters and
    draws nothing (the dry run's models)."""
    return generator.device if device is None else torch.device(device)


def dense_init(generator: torch.Generator, d_in: int,
               d_out: int, device=None) -> torch.Tensor:
    """(d_in, d_out) normal weights times d_in^-0.5, drawn on the
    generator's device (or ``device``)."""
    w = torch.randn((d_in, d_out), generator=generator,
                    device=init_device(generator, device))
    return w * d_in ** -0.5


class MLP(nn.Module):
    """Plain ReLU MLP over (in, out) weights and one bias per layer."""

    def __init__(self, weights: Sequence[torch.Tensor],
                 biases: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList(nn.Parameter(w) for w in weights)
        self.biases = nn.ParameterList(nn.Parameter(b) for b in biases)

    def forward(self, x: torch.Tensor, final_act: bool = False
                ) -> torch.Tensor:
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w
            x = x + b
            if i < n - 1 or final_act:
                x = torch.relu(x)
        return x


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             device=None) -> MLP:
    """dims = (in, h1, ..., out): dense_init weights, zero biases."""
    pairs = list(zip(dims[:-1], dims[1:]))
    dev = init_device(generator, device)
    return MLP([dense_init(generator, a, b, dev) for a, b in pairs],
               [torch.zeros((b,), device=dev) for _, b in pairs])


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w over the last axis, in f32, cast back
    to x's type."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool, q_offset: int = 0,
         kv_len_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd_v): GQA by
    head-group einsum, the softmax in f32. ``causal`` masks by absolute
    positions (query i sits at ``q_offset + i``); ``kv_len_valid`` (B,)
    masks each row's keys past its valid length (ragged decode)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    groups = h // kv
    qg = q.reshape(b, sq, kv, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / (hd ** 0.5)
    skv = k.shape[1]
    dev = q.device
    if causal:
        qpos = torch.arange(sq, device=dev) + q_offset
        kpos = torch.arange(skv, device=dev)
        mask = kpos[None, :] <= qpos[:, None]                # (Sq, Skv)
        scores = torch.where(mask[None, None, None], scores, MASKED)
    if kv_len_valid is not None:
        valid = (torch.arange(skv, device=dev)[None, :]
                 < kv_len_valid.to(dev)[:, None])
        scores = torch.where(valid[:, None, None, None, :], scores, MASKED)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def lm_dtype(cfg) -> torch.dtype:
    """The config's parameter type: bfloat16 or float32."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


# -------------------------------------------------------------------- rope
def rope_cache(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., head_dim/2), float32.

    The frequencies theta^(-i/half) are taken in float64 and rounded once
    to float32: those are the reference's bits (its power is correctly
    rounded, torch's float32 one is not), and at positions in the
    thousands an ulp of frequency moves the angle by ~1e-4."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = torch.pow(theta, expo.double()).float()
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) broadcast over heads:
    rotate-half (the first and second halves of hd pair up), in float32,
    cast back to x's type."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------- attention
def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, block_kv: int = 1024,
                 q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention: a loop over KV blocks with an online softmax.

    q (B, Sq, H, hd), k/v (B, Skv, KV, hd) -> (B, Sq, H, hd). It never
    builds the (Sq, Skv) score matrix; one step holds (B, H, Sq, block_kv)
    float32. KV heads repeat to H inside each block (head h reads KV head
    h // (H / KV), as ``sdpa``'s head groups do). As the reference: q is
    scaled by hd^-0.5 before the product, the tail block is padded with
    zero rows, masked scores are -1e30, the running max starts at -inf,
    and every block is computed, fully masked ones too. ``causal`` masks
    by absolute positions (query i sits at ``q_offset + i``: a shard's
    rows of a split sequence). The reference places the operands on a mesh
    first (``flags.HEAD_TP_ATTENTION`` picks how); the tensor-parallel
    programs (``gqa_apply_tp``) take their heads or rows explicitly."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    nblk = -(-skv // block_kv)
    qf = (q.float() * (hd ** -0.5)).transpose(1, 2)            # (B,H,Sq,hd)
    qpos = torch.arange(sq, device=dev)
    if q_offset:
        qpos = qpos + q_offset
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=dev)
    for i in range(nblk):
        start = i * block_kv
        kblk, vblk = k[:, start:start + block_kv], v[:, start:start + block_kv]
        if kblk.shape[1] < block_kv:                          # the tail
            pad = (0, 0, 0, 0, 0, block_kv - kblk.shape[1])
            kblk, vblk = F.pad(kblk, pad), F.pad(vblk, pad)
        ke = kblk.repeat_interleave(g, dim=2).float()         # (B,bkv,H,hd)
        ve = vblk.repeat_interleave(g, dim=2).float()
        s = qf @ ke.permute(0, 2, 3, 1)                       # (B,H,Sq,bkv)
        kpos = start + torch.arange(block_kv, device=dev)
        valid = kpos[None, :] < skv
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        keep = valid[None, None]
        if s.requires_grad:               # the max's backward keeps s
            s = torch.where(keep, s, MASKED)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
        else:
            # serving: in place, one (B, H, Sq, bkv) block alive at a time
            # (qwen3-32b's is 8.6 GB at 32k), the same values
            s.masked_fill_(~keep, MASKED)
            m_new = torch.maximum(m, s.amax(-1))
            p = s.sub_(m_new[..., None]).exp_()
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(-1)
        acc = acc * scale[..., None] + p @ ve.transpose(1, 2)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                    # (B,Sq,H,hd)


# attention dispatch: chunk when the quadratic term would dominate memory
CHUNK_THRESHOLD = 2048


def attention(q, k, v, *, causal: bool, block_kv: int = 1024,
              q_offset: int = 0, seq_len: Optional[int] = None):
    """``chunked_sdpa`` from CHUNK_THRESHOLD query rows on (where q's and
    v's head widths agree), ``sdpa`` below. ``seq_len``: the rows of the
    whole sequence, which decide when q holds a shard's rows of it (at
    ``q_offset``)."""
    if (seq_len or q.shape[1]) >= CHUNK_THRESHOLD and \
            q.shape[-1] == v.shape[-1]:
        return chunked_sdpa(q, k, v, causal=causal, block_kv=block_kv,
                            q_offset=q_offset)
    return sdpa(q, k, v, causal=causal, q_offset=q_offset)


# ------------------------------------------------------------ GQA attention
def gqa_init(generator: torch.Generator, cfg,
             device=None) -> nn.ParameterDict:
    """wq (d, H hd), wk / wv (d, KV hd), wo (H hd, d) from ``dense_init``,
    each cast to the config's type as it is drawn; zero QKV biases and
    unit q/k norms where the config has them."""
    dt = lm_dtype(cfg)
    dev = init_device(generator, device)
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": dense_init(generator, d, h * hd, dev).to(dt),
         "wk": dense_init(generator, d, kvh * hd, dev).to(dt),
         "wv": dense_init(generator, d, kvh * hd, dev).to(dt),
         "wo": dense_init(generator, h * hd, d, dev).to(dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return _params(p)


def gqa_qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B, S, d), positions (B, S) -> q (B, S, H, hd), k / v (B, S, KV,
    hd): the projections, the biases, per-head qk-norm, then rope on q and
    k."""
    return gqa_heads(p, cfg, *gqa_project(p, cfg, x), positions)


def gqa_project(p, cfg, x: torch.Tensor):
    """x (B, S, d) -> its products with ``p``'s wq, wk and wv (any column
    block of them), the biases added."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def gqa_heads(p, cfg, q, k, v, positions):
    """Projected q / k / v (B, S, heads x hd) -> (B, S, heads, hd), per-head
    qk-norm, rope on q and k at ``positions`` (B, S); q may be None."""
    hd = cfg.head_dim
    k = k.reshape(*k.shape[:2], -1, hd)
    v = v.reshape(*v.shape[:2], -1, hd)
    if q is not None:
        q = q.reshape(*q.shape[:2], -1, hd)
    if cfg.qk_norm:
        if q is not None:
            q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = rope_cache(positions, hd, cfg.rope_theta)
    if q is not None:
        q = apply_rope(q, cos, sin)
    return q, apply_rope(k, cos, sin), v


def gqa_apply(p, cfg, x, positions, *, causal: bool = True):
    q, k, v = gqa_qkv(p, cfg, x, positions)
    o = attention(q, k, v, causal=causal)
    return o.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def write_rows(cache: torch.Tensor, pos: torch.Tensor,
               new: torch.Tensor) -> None:
    """cache[b, pos[b]] = new[b], in place, for every row b whose position
    lies in the cache; a negative position counts from the end, and a row
    still out of range is dropped, as JAX drops an out-of-bounds scatter
    update (``ck.at[bidx, pos].set``). A dropped row writes back what it
    read, so there is no host sync and no device-side index assert."""
    smax = cache.shape[1]
    p = torch.where(pos < 0, pos + smax, pos)
    keep = (p >= 0) & (p < smax)
    p = torch.where(keep, p, torch.zeros_like(p))
    bidx = torch.arange(cache.shape[0], device=cache.device)
    keep = keep.reshape((-1,) + (1,) * (new.dim() - 1))
    cache[bidx, p] = torch.where(keep, new.to(cache.dtype), cache[bidx, p])


def gqa_decode(p, cfg, x, pos, cache: Tuple[torch.Tensor, torch.Tensor],
               kv_valid):
    """x (B, 1, d); cache (k, v) each (B, Smax, KV, hd); pos (B,) absolute.
    The new k / v are written into the cache in place (``write_rows``),
    then q attends the first ``kv_valid`` positions of each row."""
    q, k_new, v_new = gqa_qkv(p, cfg, x, pos[:, None])
    ck, cv = cache
    write_rows(ck, pos, k_new[:, 0])
    write_rows(cv, pos, v_new[:, 0])
    o = sdpa(q, ck, cv, causal=False, kv_len_valid=kv_valid)
    return o.reshape(x.shape[0], 1, -1) @ p["wo"], (ck, cv)


# ------------------------------------------------------------ MLA attention
def mla_init(generator: torch.Generator, cfg,
             device=None) -> nn.ParameterDict:
    """DeepSeek-V2's latent attention: the query through a rank
    ``q_lora_rank`` bottleneck with its norm (or one ``wq``), the joint
    KV down-projection ``wkv_a`` (d, r + rd) with the latent's norm, its
    up-projection ``wkv_b`` (r, H (nd + vd)) and ``wo`` (H vd, d)."""
    dt = lm_dtype(cfg)
    dev = init_device(generator, device)
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init(generator, d, cfg.q_lora_rank, dev).to(dt)
        p["q_a_norm"] = torch.ones((cfg.q_lora_rank,), dtype=dt, device=dev)
        p["wq_b"] = dense_init(generator, cfg.q_lora_rank, h * qd,
                               dev).to(dt)
    else:
        p["wq"] = dense_init(generator, d, h * qd, dev).to(dt)
    p["wkv_a"] = dense_init(generator, d, cfg.kv_lora_rank
                            + cfg.qk_rope_head_dim, dev).to(dt)
    p["kv_a_norm"] = torch.ones((cfg.kv_lora_rank,), dtype=dt, device=dev)
    p["wkv_b"] = dense_init(generator, cfg.kv_lora_rank,
                            h * (cfg.qk_nope_head_dim
                                 + cfg.v_head_dim), dev).to(dt)
    p["wo"] = dense_init(generator, h * cfg.v_head_dim, d, dev).to(dt)
    return _params(p)


def _mla_q(p, cfg, x, positions):
    """x (B, S, d) -> q (B, S, H, nd + rd): the no-rope part, then the
    roped part."""
    return _mla_q_heads(p, cfg, _mla_q_a(p, cfg, x), positions)


def _mla_q_a(p, cfg, x):
    """The query's replicated part: the normed rank-``q_lora_rank``
    bottleneck, or x itself where the config has none."""
    if cfg.q_lora_rank:
        return rms_norm(x @ p["wq_a"], p["q_a_norm"], cfg.rms_eps)
    return x


def _mla_q_heads(p, cfg, qa, positions):
    """``_mla_q_a``'s output -> q (B, S, heads, nd + rd) of ``p``'s heads
    (any column block of wq_b / wq), rope on the last rd."""
    b, s, _ = qa.shape
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = qa @ (p["wq_b"] if cfg.q_lora_rank else p["wq"])
    q = q.reshape(b, s, -1, nd + rd)
    cos, sin = rope_cache(positions, rd, cfg.rope_theta)
    return torch.cat([q[..., :nd], apply_rope(q[..., nd:], cos, sin)],
                     dim=-1)


def _mla_latent(p, cfg, x, positions):
    """x (B, S, d) -> the normed latent c_kv (B, S, r) and the roped
    shared key k_rope (B, S, rd): what the MLA cache holds."""
    r, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    a = x @ p["wkv_a"]
    c_kv = rms_norm(a[..., :r], p["kv_a_norm"], cfg.rms_eps)
    cos, sin = rope_cache(positions, rd, cfg.rope_theta)
    k_rope = apply_rope(a[..., r:][:, :, None, :], cos, sin)[:, :, 0]
    return c_kv, k_rope


def _mla_kv_from_latent(p, cfg, c_kv, k_rope):
    """latent c_kv (B, S, r) + k_rope (B, S, rd) -> the full k (B, S, H,
    nd + rd) (k_rope shared by every head) and v (B, S, H, vd), of
    ``p``'s heads (any column block of wkv_b)."""
    return _mla_kv_heads(cfg, c_kv @ p["wkv_b"], k_rope)


def _mla_kv_heads(cfg, kv, k_rope):
    """``c_kv @ wkv_b`` (B, S, heads x (nd + vd)) and k_rope -> k, v."""
    b, s, _ = kv.shape
    nd, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = kv.reshape(b, s, -1, nd + vd)
    rope = k_rope[:, :, None, :].expand(b, s, kv.shape[2], k_rope.shape[-1])
    return torch.cat([kv[..., :nd], rope], dim=-1), kv[..., nd:]


def mla_attend(q, k, v, *, causal: bool = True, q_offset: int = 0,
               seq_len: Optional[int] = None):
    """Attention of MLA's q / k (width nd + rd) over v (width vd).
    From CHUNK_THRESHOLD query rows on, v is zero-padded to q's width so
    that ``chunked_sdpa`` can run, and the output is cut back to vd (the
    reference's own detour: ``attention`` would fall back to ``sdpa`` on
    the unequal widths, whose (B, H, S, S) float32 scores are 34 GB at
    128 heads x 8,192 tokens); below it, ``sdpa`` takes the unequal
    widths. ``q_offset`` / ``seq_len``: a shard's rows of the sequence,
    as ``attention``'s."""
    if (seq_len or q.shape[1]) >= CHUNK_THRESHOLD:
        vd = v.shape[-1]
        vpad = F.pad(v, (0, q.shape[-1] - vd))
        return chunked_sdpa(q, k, vpad, causal=causal,
                            q_offset=q_offset)[..., :vd]
    return sdpa(q, k, v, causal=causal, q_offset=q_offset)


def mla_apply(p, cfg, x, positions, *, causal: bool = True):
    b, s, _ = x.shape
    q = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k, v = _mla_kv_from_latent(p, cfg, c_kv, k_rope)
    o = mla_attend(q, k, v, causal=causal)
    return o.reshape(b, s, -1) @ p["wo"]


def _mla_decode_latent(p, cfg, x, pos, cache):
    """The decode's q (B, 1, H, nd + rd); the new latent and rope key
    written into the cache (c_kv (B, Smax, r), k_rope (B, Smax, rd)) in
    place at ``pos`` (a write past the cache is dropped)."""
    q = _mla_q(p, cfg, x, pos[:, None])
    c_new, kr_new = _mla_latent(p, cfg, x, pos[:, None])
    cc, ckr = cache
    write_rows(cc, pos, c_new[:, 0])
    write_rows(ckr, pos, kr_new[:, 0])
    return q


def mla_decode_absorbed(p, cfg, x, pos, cache, kv_valid):
    """MLA decode with weight absorption (DeepSeek-V2's inference form):
    ``wkv_b`` folds into the query (``q_nope W_uk`` scores the latent
    cache directly) and the output (the context is taken in latent space,
    then ``W_uv``), so the (B, S, H, nd + vd) keys and values are never
    rebuilt. As the reference, every product and the softmax run in
    float32 (the cache read is upcast), scores are divided by
    sqrt(nd + rd) and masked to -1e30 from ``kv_valid`` on, and the
    context is cast to x's type before ``wo``. x (B, 1, d); cache (c_kv,
    k_rope), written in place."""
    b = x.shape[0]
    h = cfg.n_heads
    nd, rd, vd, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    q = _mla_decode_latent(p, cfg, x, pos, cache)
    cc, ckr = cache
    wkv_b = p["wkv_b"].reshape(r, h, nd + vd)
    w_uk, w_uv = wkv_b[..., :nd].float(), wkv_b[..., nd:].float()
    q_lat = torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nd].float(), w_uk)
    ccf = cc.float()                                          # (B, S, r)
    s_nope = q_lat @ ccf.transpose(1, 2)                      # (B, H, S)
    s_rope = q[:, 0, :, nd:].float() @ ckr.float().transpose(1, 2)
    scores = (s_nope + s_rope) / ((nd + rd) ** 0.5)
    del s_nope, s_rope
    valid = (torch.arange(cc.shape[1], device=x.device)[None, :]
             < kv_valid.to(x.device)[:, None])
    scores = torch.where(valid[:, None, :], scores, MASKED)
    w = torch.softmax(scores, dim=-1)
    del scores
    ctx = w @ ccf                                             # (B, H, r)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    out = o.reshape(b, 1, h * vd).to(x.dtype) @ p["wo"]
    return out, (cc, ckr)


def mla_decode(p, cfg, x, pos, cache, kv_valid):
    """MLA decode that rebuilds the full K / V from the latent cache (the
    reference's ``mla_decode``; ``decode_step`` uses the absorbed form,
    and the tests hold the two against each other)."""
    b = x.shape[0]
    q = _mla_decode_latent(p, cfg, x, pos, cache)
    k, v = _mla_kv_from_latent(p, cfg, *cache)
    o = sdpa(q, k, v, causal=False, kv_len_valid=kv_valid)
    return o.reshape(b, 1, -1) @ p["wo"], cache


# ------------------------------------------------------------------- ffn
def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype: torch.dtype, device=None) -> nn.ParameterDict:
    dev = init_device(generator, device)
    return _params({
        "w_gate": dense_init(generator, d, d_ff, dev).to(dtype),
        "w_up": dense_init(generator, d, d_ff, dev).to(dtype),
        "w_down": dense_init(generator, d_ff, d, dev).to(dtype)})


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ------------------------------------------- tensor parallel (``model``)
# One batch group's programs over a mesh's ``model`` axis: ``attns`` /
# ``ffns`` hold each shard's parameter blocks (``sharding.shard_lm``), a
# replicated tensor lies on the group's first device, and the collectives
# are ``distributed.tensor_parallel``'s (its docstring). A block's split
# is its weights': "heads" / "seq" (Megatron's column- then row-parallel
# attention), "tp" (the same for an FFN), "cols" (every weight
# replicated but the last, split on its output columns: the reference's
# rules on an MoE config's leading dense block) or "rep".

def _out_proj(grp, ps, o, mode: str, name: str = "wo"):
    """A replicated ``o`` times ``ps``' last weight ``name``: replicated
    ("rep") or split on its output columns and gathered ("cols")."""
    if mode == "cols":
        return TP.out_cols(grp, [p[name] for p in ps], o)
    return grp.local(torch.matmul, o, ps[0][name])

def _q_heads(p, cfg, q, positions):
    """Projected q (B, S, H x hd) -> heads, qk-norm, rope at
    ``positions``."""
    q = q.reshape(*q.shape[:2], -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    cos, sin = rope_cache(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin)


def _kv_for(cfg, k, v, s: int, n: int):
    """Shard s of n's K / V heads out of all of them (B, S, KV, hd): the
    ones its H / n query heads read (head h reads KV head h // (H / KV))."""
    hq, gs = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    if gs % hq and hq % gs:
        raise ValueError(f"{hq} query heads a shard straddle groups of "
                         f"{gs}: no head-TP split of {cfg.n_heads} / "
                         f"{cfg.n_kv_heads} heads over {n} shards")
    w = max(1, hq // gs)
    return k.narrow(2, s * hq // gs, w), v.narrow(2, s * hq // gs, w)


def _attend_split(grp, cfg, q, k, v, mode: str, attend):
    """Attention of replicated q (B, S, H, .), k / v (B, S, KV, .) on
    ``home``, split over the shards: "heads", shard s its H / n query heads
    and the KV heads they read; "seq", its S / n query rows against all of
    k / v. The shards' outputs gathered on ``home``, (B, S, H x vd). The
    backward sums the shards' gradients of q, k and v (all-reduces)."""
    n = grp.size
    b, s, h = q.shape[:3]
    qs, ks, vs = (TP.fan_out(grp, t) for t in (q, k, v))
    run = list(enumerate(grp.shards))
    if mode == "heads":
        hq = h // n

        def heads(i, q_, k_, v_):
            kk, vv = _kv_for(cfg, k_, v_, i, n) if k_.shape[2] != h else (
                k_[:, :, i * hq:(i + 1) * hq], v_[:, :, i * hq:(i + 1) * hq])
            return attend(q_[:, :, i * hq:(i + 1) * hq], kk, vv).reshape(
                b, s, -1)
        return TP.all_gather(grp, [grp.run(i, heads, i, qs[j], ks[j], vs[j])
                                   for j, i in run], -1)
    rows = s // n

    def seq(i, q_, k_, v_):
        return attend(q_[:, i * rows:(i + 1) * rows], k_, v_,
                      q_offset=i * rows, seq_len=s).reshape(b, rows, -1)
    return TP.all_gather(grp, [grp.run(i, seq, i, qs[j], ks[j], vs[j])
                               for j, i in run], 1)


def _causal(q, k, v, **kw):
    return attention(q, k, v, causal=True, **kw)


def gqa_apply_tp(grp, attns, cfg, h, positions, mode: str, split: str):
    """Causal GQA attention of one batch group, h (B, S, d) on its first
    device -> (the output there, each running shard's K / V after rope:
    its own KV heads, or all of them).

    ``mode`` "rep": every device computes the whole. "heads" (head-TP):
    shard s takes its H / n query heads and the KV heads they read.
    "seq" (sequence-parallel): shard s takes its S / n query rows against
    the group's whole K / V. ``split``, the weights': "tp", shard s
    projects its heads from its column blocks of wq / wk / wv (its own KV
    heads when they divide, else all of them gathered; in "seq" its q
    columns are traded for q rows by an all-to-all, K / V gathered, the
    output traded back) and a row-parallel ``wo`` ends in an all-reduce;
    "rep" / "cols", q / k / v are projected replicated, the split's
    outputs gathered, and ``wo`` (``_out_proj``) is replicated or split on
    its output columns."""
    b, s, _ = h.shape
    if split != "tp":
        q, k, v = grp.local(gqa_qkv, attns[0], cfg, h, positions)
        if mode == "rep":
            o = grp.local(lambda: _causal(q, k, v).reshape(b, s, -1))
        else:
            o = _attend_split(grp, cfg, q, k, v, mode, _causal)
        return _out_proj(grp, attns, o, split), \
            list(zip(TP.replicate(grp, k), TP.replicate(grp, v)))
    n = grp.size
    hs = TP.fan_out(grp, h)
    proj = [grp.run(i, gqa_project, attns[i], cfg, hs[i])
            for i in grp.shards]
    own = mode == "heads" and cfg.n_kv_heads % n == 0
    if own:
        kvs = [(pk, pv) for _, pk, pv in proj]
    else:
        kvs = list(zip(TP.all_gather_to_shards(grp, [x[1] for x in proj], -1),
                       TP.all_gather_to_shards(grp, [x[2] for x in proj], -1)))
    if mode == "heads":
        def shard(i, p, q, k, v):
            q, k, v = gqa_heads(p, cfg, q, k, v, positions.to(q.device))
            ks, vs = (k, v) if own else _kv_for(cfg, k, v, i, n)
            o = attention(q, ks, vs, causal=True)
            return o.reshape(b, s, -1) @ p["wo"], k, v
        outs = [grp.run(i, shard, i, attns[i], proj[k_][0], *kvs[k_])
                for k_, i in enumerate(grp.shards)]
        return TP.all_reduce(grp, [o[0] for o in outs]), \
            [o[1:] for o in outs]
    rows = s // n
    q_rows = TP.all_to_all(grp, [x[0] for x in proj], 1, 2)

    def attend(i, p, q, k, v):
        pos = positions.to(q.device)
        q = _q_heads(p, cfg, q, pos[:, i * rows:(i + 1) * rows])
        _, k, v = gqa_heads(p, cfg, None, k, v, pos)
        o = attention(q, k, v, causal=True, q_offset=i * rows, seq_len=s)
        return o.reshape(b, rows, -1), k, v
    att = [grp.run(i, attend, i, attns[i], q_rows[k_], *kvs[k_])
           for k_, i in enumerate(grp.shards)]
    o_cols = TP.all_to_all(grp, [a[0] for a in att], 2, 1)
    parts = [grp.run(i, torch.matmul, o_cols[k_], attns[i]["wo"])
             for k_, i in enumerate(grp.shards)]
    return TP.all_reduce(grp, parts), [a[1:] for a in att]


def swiglu_apply_tp(grp, ffns, h, mode: str, hs=None):
    """The SwiGLU of one batch group: "tp", column-parallel ``w_gate`` /
    ``w_up`` then row-parallel ``w_down`` and an all-reduce (on ``hs``,
    the shards' copies of h, where the caller fanned it out already);
    "cols", the gate replicated and ``w_down`` split on its output
    columns; "rep", replicated."""
    if mode == "rep":
        return grp.local(swiglu_apply, ffns[0], h)
    if mode == "cols":
        a = grp.local(lambda p: F.silu(h @ p["w_gate"]) * (h @ p["w_up"]),
                      ffns[0])
        return _out_proj(grp, ffns, a, mode, "w_down")
    hs = hs if hs is not None else TP.fan_out(grp, h)
    return TP.all_reduce(grp, [grp.run(i, swiglu_apply, ffns[i], hs[k])
                               for k, i in enumerate(grp.shards)])


def sdpa_partial(q, k, v, valid):
    """``sdpa``'s softmax over one block of keys, unnormalised: q (B, Sq,
    H, hd), k / v (B, Sb, KV, hd), valid (B, Sb) -> float32 max m (B, KV,
    G, Sq), sum l (B, KV, G, Sq) and weighted values acc (B, KV, G, Sq,
    hd), each term relative to the block's own max."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(),
                          k.float()) / (hd ** 0.5)
    scores = torch.where(valid[:, None, None, None, :], scores, MASKED)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    return m, p.sum(-1), torch.einsum("bkgqs,bskh->bkgqh", p, v.float())


def _local_pos(pos, lo: int, size: int, smax: int):
    """Global cache positions -> a block of ``size`` positions from
    ``lo``'s own, ``size`` (dropped by ``write_rows``) where outside it."""
    gp = torch.where(pos < 0, pos + smax, pos)
    lp = gp - lo
    return torch.where((lp >= 0) & (lp < size), lp, size)


@torch.no_grad()
def gqa_decode_tp(grp, attns, cfg, x, pos, caches, kv_valid, split: str,
                  mode: str):
    """One decode step of one batch group's attention, x (B, 1, d) on its
    first device; ``caches``: each shard's (k, v) block of this layer,
    written in place. ``mode`` "tp": column-parallel wq / wk / wv and a
    row-parallel ``wo``; "cols" / "rep": q, k and v replicated, ``wo``
    split on its output columns or replicated (``_out_proj``).
    ``split`` "heads": shard s decodes its KV heads and their query heads
    (``gqa_decode`` on its blocks; or, from replicated q / k / v, its
    heads' slices, the outputs gathered). "seq": every shard holds all
    heads over its positions; q and the new k / v (gathered where
    column-parallel) go to every shard, each writes the new entry if it
    holds the position and scores its own positions; the shards' partial
    softmaxes (max, sum, weighted values) are combined by an all-reduce of
    the max and one of the rescaled sums, exact up to float order."""
    n = grp.size
    b = x.shape[0]
    xs = TP.replicate(grp, x)
    tp = mode == "tp"
    if split == "heads" and tp:
        cfg_s = replace(cfg, n_heads=cfg.n_heads // n,
                        n_kv_heads=cfg.n_kv_heads // n)
        parts = [grp.run(i, lambda i, k_: gqa_decode(
            attns[i], cfg_s, xs[k_], pos.to(xs[k_].device), caches[k_],
            kv_valid.to(xs[k_].device))[0], i, k_)
            for k_, i in enumerate(grp.shards)]
        return TP.all_reduce(grp, parts)
    if tp:
        proj = [grp.run(i, gqa_project, attns[i], cfg, xs[k_])
                for k_, i in enumerate(grp.shards)]
        q, k, v = (TP.all_gather(grp, [x_[j] for x_ in proj], -1)
                   for j in range(3))
    else:
        q, k, v = grp.local(gqa_project, attns[0], cfg, x)
    q, k, v = grp.local(gqa_heads, attns[0], cfg, q, k, v, pos[:, None])
    qs, ks, vs = (TP.replicate(grp, t) for t in (q, k, v))
    if split == "heads":
        kvh, hq = cfg.n_kv_heads // n, cfg.n_heads // n

        def own(i, k_):
            ck, cv = caches[k_]
            dev = ck.device
            write_rows(ck, pos.to(dev), ks[k_][:, 0, i * kvh:(i + 1) * kvh])
            write_rows(cv, pos.to(dev), vs[k_][:, 0, i * kvh:(i + 1) * kvh])
            o = sdpa(qs[k_][:, :, i * hq:(i + 1) * hq], ck, cv, causal=False,
                     kv_len_valid=kv_valid.to(dev))
            return o.reshape(b, 1, -1)
        o = TP.all_gather(grp, [grp.run(i, own, i, k_)
                                for k_, i in enumerate(grp.shards)], -1)
        return _out_proj(grp, attns, o, mode)
    size = caches[0][0].shape[1]

    def block(i, k_):
        ck, cv = caches[k_]
        dev = ck.device
        lp = _local_pos(pos.to(dev), i * size, size, n * size)
        write_rows(ck, lp, ks[k_][:, 0])
        write_rows(cv, lp, vs[k_][:, 0])
        valid = (i * size + torch.arange(size, device=dev))[None, :] \
            < kv_valid.to(dev)[:, None]
        return sdpa_partial(qs[k_], ck, cv, valid)
    pieces = [grp.run(i, block, i, k_) for k_, i in enumerate(grp.shards)]
    tot = _combine(grp, pieces)

    def finish(tot):
        o = tot[..., 1:] / tot[..., :1]                   # (B, KV, G, 1, hd)
        return o.permute(0, 3, 1, 2, 4).reshape(b, 1, -1).to(x.dtype)
    o = grp.local(finish, tot)
    if not tp:
        return _out_proj(grp, attns, o, mode)
    os_ = TP.replicate(grp, o)
    w = o.shape[-1] // n
    return TP.all_reduce(grp, [grp.run(
        i, lambda o_, wo: o_[..., i * w:(i + 1) * w] @ wo, os_[k_],
        attns[i]["wo"]) for k_, i in enumerate(grp.shards)])


def _combine(grp, pieces):
    """The shards' partial softmaxes (max, sum, weighted values) combined:
    an all-reduce of the max, then one of the sums and values rescaled to
    it, side by side (the sum first) on ``home``."""
    top = TP.replicate(grp, TP.all_reduce_max(grp, [m for m, _, _ in
                                                    pieces]))

    def rescale(k_, m, l, acc):
        w = torch.exp(m - top[k_])
        return torch.cat([(l * w)[..., None], acc * w[..., None]], dim=-1)
    return TP.all_reduce(grp, [grp.run(i, rescale, k_, *pieces[k_])
                               for k_, i in enumerate(grp.shards)])


# ------------------------------------------------------- MLA over ``model``
def mla_apply_tp(grp, attns, cfg, h, positions, mode: str, split: str):
    """Causal MLA attention of one batch group, h (B, S, d) on its first
    device -> (the output there, the latent c_kv (B, S, r) and k_rope
    (B, S, rd) there: what the cache holds).

    ``mode`` and ``split`` as ``gqa_apply_tp``'s. ``split`` "rep" /
    "cols": q, k and v are projected replicated. "tp": the
    down-projections ``wq_a`` / ``wkv_a`` and their norms run once
    (replicated); shard s takes its H / n heads' q, k and v from its
    column blocks of ``wq_b`` (or ``wq``) and ``wkv_b``. In "heads" it
    attends its heads; in "seq" its S / n query rows of every head: q
    traded from columns to rows by an all-to-all, the up-projected latent
    (B, S, H / n x (nd + vd)) gathered, the output traded back. Either
    ends in a row-parallel ``wo`` and an all-reduce."""
    b, s, _ = h.shape
    if split != "tp":
        def proj(p):
            q = _mla_q(p, cfg, h, positions)
            c_kv, k_rope = _mla_latent(p, cfg, h, positions)
            return (q,) + _mla_kv_from_latent(p, cfg, c_kv, k_rope) + (
                c_kv, k_rope)
        q, k, v, c_kv, k_rope = grp.local(proj, attns[0])
        if mode == "rep":
            o = grp.local(lambda: mla_attend(q, k, v).reshape(b, s, -1))
        else:
            o = _attend_split(grp, cfg, q, k, v, mode, mla_attend)
        return _out_proj(grp, attns, o, split), (c_kv, k_rope)

    def down(p):
        return (_mla_q_a(p, cfg, h),) + _mla_latent(p, cfg, h, positions)
    qa, c_kv, k_rope = grp.local(down, attns[0])
    qas, cs, krs = (TP.fan_out(grp, t) for t in (qa, c_kv, k_rope))
    run = list(enumerate(grp.shards))
    if mode == "heads":
        def shard(i, p, qa_, c, kr):
            pos = positions.to(qa_.device)
            q = _mla_q_heads(p, cfg, qa_, pos)
            k, v = _mla_kv_from_latent(p, cfg, c, kr)
            return mla_attend(q, k, v).reshape(b, s, -1) @ p["wo"]
        return TP.all_reduce(grp, [grp.run(i, shard, i, attns[i], qas[j],
                                           cs[j], krs[j]) for j, i in run]
                             ), (c_kv, k_rope)
    n = grp.size
    rows = s // n
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

    def proj(p, qa_, c):
        q = _mla_q_heads(p, cfg, qa_, positions.to(qa_.device))
        return q.reshape(b, s, -1), c @ p["wkv_b"]
    pr = [grp.run(i, proj, attns[i], qas[j], cs[j]) for j, i in run]
    q_rows = TP.all_to_all(grp, [x[0] for x in pr], 1, 2)
    kvs = TP.all_gather_to_shards(grp, [x[1] for x in pr], -1)

    def attend(i, q, kv, kr):
        k, v = _mla_kv_heads(cfg, kv, kr)
        o = mla_attend(q.reshape(b, rows, -1, qd), k, v,
                       q_offset=i * rows, seq_len=s)
        return o.reshape(b, rows, -1)
    att = [grp.run(i, attend, i, q_rows[j], kvs[j], krs[j]) for j, i in run]
    o_cols = TP.all_to_all(grp, att, 2, 1)
    return TP.all_reduce(grp, [grp.run(i, torch.matmul, o_cols[j],
                                       attns[i]["wo"]) for j, i in run]
                         ), (c_kv, k_rope)


@torch.no_grad()
def mla_decode_tp(grp, attns, cfg, x, pos, caches, kv_valid, mode: str):
    """One absorbed MLA decode step (``mla_decode_absorbed``) of one batch
    group, x (B, 1, d) on its first device, over a latent cache split on
    sequence: ``caches`` each shard's (c_kv, k_rope) block of this layer,
    written in place by the shard that holds ``pos``.

    The down-projections and the new latent run replicated. ``mode``
    "tp": shard s folds its heads' ``W_uk`` (its column block of
    ``wkv_b``) into its heads' query, and the latent queries q_lat (B, H,
    r) and their rope parts (B, H, rd) are gathered over ``model``;
    "cols" / "rep": every device computes them for all heads. Each shard
    scores its own positions and keeps a partial softmax in latent space;
    the partials are combined as ``gqa_decode_tp``'s (an all-reduce of the
    max, one of the rescaled sums). Then ``W_uv``: in "tp" each shard its
    heads' and a row-parallel ``wo``; else replicated, ``wo`` by
    ``_out_proj``."""
    n = grp.size
    b, hh = x.shape[0], cfg.n_heads
    nd, rd, vd, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim, cfg.kv_lora_rank)
    tp = mode == "tp"

    def down(p):
        return (_mla_q_a(p, cfg, x),) + _mla_latent(p, cfg, x, pos[:, None])
    qa, c_new, kr_new = grp.local(down, attns[0])

    def query(p, qa_):
        q = _mla_q_heads(p, cfg, qa_, pos[:, None].to(qa_.device))
        w_uk = p["wkv_b"].reshape(r, -1, nd + vd)[..., :nd].float()
        return (torch.einsum("bhn,rhn->bhr", q[:, 0, :, :nd].float(), w_uk),
                q[:, 0, :, nd:].float())
    if tp:
        qas = TP.replicate(grp, qa)
        qs = [grp.run(i, query, attns[i], qas[j])
              for j, i in enumerate(grp.shards)]
        q_lat, q_rope = (TP.all_gather(grp, [q[m] for q in qs], 1)
                         for m in range(2))
    else:
        q_lat, q_rope = grp.local(query, attns[0], qa)
    ql, qr, cn, krn = (TP.replicate(grp, t)
                       for t in (q_lat, q_rope, c_new, kr_new))
    size = caches[0][0].shape[1]

    def block(i, j):
        cc, ckr = caches[j]
        dev = cc.device
        lp = _local_pos(pos.to(dev), i * size, size, n * size)
        write_rows(cc, lp, cn[j][:, 0])
        write_rows(ckr, lp, krn[j][:, 0])
        ccf = cc.float()
        s_nope = ql[j] @ ccf.transpose(1, 2)                  # (B, H, S/n)
        s_rope = qr[j] @ ckr.float().transpose(1, 2)
        scores = (s_nope + s_rope) / ((nd + rd) ** 0.5)
        valid = (i * size + torch.arange(size, device=dev))[None, :] \
            < kv_valid.to(dev)[:, None]
        scores = torch.where(valid[:, None, :], scores, MASKED)
        m = scores.amax(-1)
        p = torch.exp(scores - m[..., None])
        return m, p.sum(-1), p @ ccf                          # (B, H, r)
    pieces = [grp.run(i, block, i, j) for j, i in enumerate(grp.shards)]
    tot = _combine(grp, pieces)
    ctx = grp.local(lambda t: t[..., 1:] / t[..., :1], tot)   # (B, H, r)

    def up(p, c, lo: int, heads: int):
        w_uv = p["wkv_b"].reshape(r, heads, nd + vd)[..., nd:].float()
        o = torch.einsum("bhr,rhv->bhv", c[:, lo:lo + heads], w_uv)
        return o.reshape(b, 1, heads * vd).to(x.dtype)
    if not tp:
        return _out_proj(grp, attns, grp.local(up, attns[0], ctx, 0, hh),
                         mode)
    cs = TP.replicate(grp, ctx)
    hs = hh // n
    return TP.all_reduce(grp, [grp.run(
        i, lambda p, c: up(p, c, i * hs, hs) @ p["wo"], attns[i], cs[j])
        for j, i in enumerate(grp.shards)])
