"""Synthetic LAION-like vectors (the reference's ``data/synthetic.py``
recipe, drawn from a ``torch.Generator``).

The recipe is the reference's: a Gaussian mixture with Zipf-ish cluster
weights and a decaying per-dimension spectrum, so PCA has headroom and the
kNN graph has hubs. A torch generator does not reproduce ``jax.random``'s
bits, so tests that compare the two packages make their inputs with numpy.
Every tensor is drawn on the generator's device.
"""
from __future__ import annotations

import torch


def clustered_vectors(generator: torch.Generator, n: int, dim: int,
                      n_clusters: int = 64, spectrum_decay: float = 0.95,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    dev = generator.device
    scales = spectrum_decay ** torch.arange(dim, dtype=torch.float32,
                                            device=dev)
    centers = torch.randn((n_clusters, dim), generator=generator,
                          device=dev) * scales[None, :]
    w = 1.0 / (1.0 + torch.arange(n_clusters, dtype=torch.float32,
                                  device=dev))
    w = w / w.sum()
    assign = torch.multinomial(w, n, replacement=True, generator=generator)
    noise = torch.randn((n, dim), generator=generator,
                        device=dev) * scales[None, :]
    return (centers[assign] + noise).to(dtype)


def queries_like(generator: torch.Generator, data: torch.Tensor,
                 n_queries: int, jitter: float = 0.05) -> torch.Tensor:
    """In-distribution queries: perturbed database points (paper §5.2's
    'consistent query distribution' assumption)."""
    dev = generator.device
    idx = torch.randint(0, data.shape[0], (n_queries,), generator=generator,
                        device=dev)
    noise = torch.randn((n_queries, data.shape[1]), generator=generator,
                        device=dev, dtype=data.dtype)
    return data[idx.to(data.device)] + jitter * noise.to(data.device)
