"""Device dispatch for exact L2 distance + top-k (the kNN passes, k-means
assignment, entry-point selection and the brute-force ground truth)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.l2topk.l2topk import l2topk_cuda
from repro_torch.kernels.l2topk.ref import l2_topk_ref


def l2_topk(queries: torch.Tensor, database: torch.Tensor, k: int,
            chunk: int = 16384, backend: Optional[str] = None):
    """(Q, D), (N, D) -> (dists (Q, k) f32 ascending, ids (Q, k) int32),
    ties by lower id, k cut to N: the CUDA kernels for CUDA tensors (the
    variant ``l2topk.route`` picks by shape; they take no ``chunk``: none
    holds the (Q, N) matrix), the plain version for CPU tensors; on meta
    tensors the outputs, no launch."""
    if use_kernel(database, backend, "l2topk", meta=True):
        return l2topk_cuda(queries.float().contiguous(),
                           database.float().contiguous(), k)
    return l2_topk_ref(queries, database, k, chunk=chunk)
