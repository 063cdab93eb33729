"""Token sampling for the LM decode loop (the reference's
``serve/sampling.py``).

``sample_token`` is greedy at ``temperature <= 0``; otherwise it divides
the logits by the temperature, keeps the ``top_k`` largest (the rest at
-1e30) and draws by the Gumbel-max trick, ``argmax(gumbel + logits)``,
which is what ``jax.random.categorical`` computes. torch cannot replay a
``jax.random`` stream, so the draw is an argument (ROADMAP's randomness
rule): ``gumbel=`` takes standard Gumbel noise of the logits' shape (the
reference's ``jax.random.gumbel(key, logits.shape)`` in a parity test);
without it the noise comes from ``generator`` (a ``torch.Generator``,
seeded 0 on the logits' device when none is given).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models.layers import MASKED


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """-log(-log(U)), U uniform on [tiny, 1) in float32 (the reference's
    ``jax.random.gumbel`` recipe, from a torch generator)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, temperature: float = 1.0,
                 top_k: int = 0, gumbel: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32. temperature <= 0 is greedy;
    ties go to the lowest id, as ``argmax`` in both packages."""
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, MASKED, logits)
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device=logits.device).manual_seed(0)
        gumbel = gumbel_noise(logits.shape, generator)
    return (gumbel.to(logits.device) + logits).argmax(-1).to(torch.int32)


def generate(model, cfg, decode_step, prompt_cache, first_token, pos0,
             n_tokens: int, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             gumbels: Optional[Sequence[torch.Tensor]] = None):
    """Greedy / sampled autoregressive loop over ``decode_step(model,
    token, cache, pos)`` (``serve_step.lm_decode_step(cfg)``): n_tokens
    steps from ``first_token`` at ``pos0`` -> ((B, n_tokens) ids, cache).
    ``gumbels`` gives step t's draw as ``gumbels[t]``; without it the
    draws come from ``generator``. The cache is written in place."""
    if gumbels is None and generator is None and temperature > 0:
        generator = torch.Generator(
            device=first_token.device).manual_seed(0)
    tokens = [first_token]
    cache = prompt_cache
    pos = pos0
    for t in range(n_tokens):
        logits, cache = decode_step(model, tokens[-1], cache, pos)
        tokens.append(sample_token(
            logits, temperature, top_k,
            gumbel=None if gumbels is None else gumbels[t],
            generator=generator))
        pos = pos + 1
    return torch.stack(tokens[1:], dim=1), cache
