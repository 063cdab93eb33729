"""int8 error-feedback gradient compression (the reference's
``optim/compression.py``).

Per-parameter blockwise symmetric int8 quantization with an error-feedback
accumulator (1-bit-Adam-style residual correction): the quantization
error of step t is added to the gradient of step t+1, so the compression
bias vanishes and convergence is kept. On a real fabric the all-reduce
would move the int8 payloads (4x less than f32); the values here are
exactly what that wire format carries.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim.adamw import Params, named

BLOCK = 256


def init_error_state(params: Params) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named(params).items()}


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1).float()
    fp = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    fp = fp.reshape(-1, BLOCK)
    scale = (fp.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.round(fp / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor,
                     shape) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    return deq[:shape.numel()].reshape(shape)


def compress_with_feedback(grads: Dict[str, torch.Tensor],
                           err_state: Dict[str, torch.Tensor]):
    """grads + carried error -> (dequantized grads, new error state), two
    new dicts. The returned grads are exactly what the int8 wire format
    transports."""
    out_g, out_e = {}, {}
    for n, g in grads.items():
        corrected = g.float() + err_state[n]
        q, scale = _quantize_leaf(corrected)
        deq = _dequantize_leaf(q, scale, g.shape)
        out_g[n] = deq.to(g.dtype)
        out_e[n] = corrected - deq
    return out_g, out_e


def compression_ratio(params: Params) -> float:
    """Wire bytes in int8 (payload and scales) against f32."""
    sizes = [p.numel() for p in named(params).values()]
    total = sum(sizes)
    blocks = sum(-(-s // BLOCK) for s in sizes)
    return (total * 1 + blocks * 4) / (total * 4)
