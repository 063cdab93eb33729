"""Dense building blocks of the recsys models (the reference's
``models/layers.py``: ``dense_init``, ``mlp_init``/``mlp_apply``,
``rms_norm`` and ``sdpa``).

The arithmetic is the reference's: weights are stored (in, out), a layer is
``x @ w`` and then ``+ b`` as a separate op, with ReLU between layers. Not
``nn.Linear``/``addmm``: fusing the bias into the product would round
differently, and the (in, out) layout carries the reference's weights
without a transpose. ``sdpa`` is the reference's einsum attention in plain
tensor ops (GQA head groups, f32 softmax, the -1e30 mask): it is no Pallas
kernel there either, and the plain ops keep its arithmetic for the parity
tests.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

MASKED = -1e30        # the reference's masked score (not -inf: no NaN rows)


def dense_init(generator: torch.Generator, d_in: int,
               d_out: int) -> torch.Tensor:
    """(d_in, d_out) normal weights times d_in^-0.5, drawn on the
    generator's device."""
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device)
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


def mlp_init(generator: torch.Generator, dims: Sequence[int]) -> MLP:
    """dims = (in, h1, ..., out): dense_init weights, zero biases."""
    pairs = list(zip(dims[:-1], dims[1:]))
    return MLP([dense_init(generator, a, b) for a, b in pairs],
               [torch.zeros((b,), device=generator.device)
                for _, b in pairs])


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
