"""PCA dimensionality reduction (paper §3.1, knob D).

Fit by eigendecomposition of the (D0, D0) covariance (``torch.linalg.eigh``);
transform is one matmul. Eigenvector signs are arbitrary, so a projection
equals the reference's up to a per-column sign.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PCA:
    mean: torch.Tensor          # (D0,)
    components: torch.Tensor    # (D0, D) top-D eigvecs, column-major
    explained: torch.Tensor     # (D,) explained-variance ratios (descending)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) @ self.components

    def inverse_transform(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.components.T + self.mean


def fit_pca(x: torch.Tensor, dim: int) -> PCA:
    if not 1 <= dim <= x.shape[1]:
        raise ValueError(f"pca dim {dim} out of range (1, {x.shape[1]})")
    x32 = x.float()
    mean = x32.mean(0)
    xc = x32 - mean
    cov = (xc.T @ xc) / (x.shape[0] - 1)
    evals, evecs = torch.linalg.eigh(cov)            # ascending
    evals, evecs = evals.flip(0), evecs.flip(1)
    total = evals.sum().clamp_min(1e-12)
    return PCA(mean=mean, components=evecs[:, :dim].contiguous(),
               explained=evals[:dim] / total)


def dim_for_energy(x: torch.Tensor, energy: float) -> int:
    """Smallest D capturing ``energy`` fraction of variance (tuner helper):
    the first cumulative explained share >= ``energy`` (the reference's
    ``searchsorted``, left side), plus one."""
    cum = torch.cumsum(fit_pca(x, x.shape[1]).explained, 0)
    target = torch.tensor([energy], dtype=cum.dtype, device=cum.device)
    return int(torch.searchsorted(cum, target)[0]) + 1
