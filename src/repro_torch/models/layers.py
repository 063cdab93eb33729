"""Dense building blocks of the recsys models (the reference's
``models/layers.py``: ``dense_init``, ``mlp_init``/``mlp_apply``).

The arithmetic is the reference's: weights are stored (in, out), a layer is
``x @ w`` and then ``+ b`` as a separate op, with ReLU between layers. Not
``nn.Linear``/``addmm``: fusing the bias into the product would round
differently, and the (in, out) layout carries the reference's weights
without a transpose.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


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
