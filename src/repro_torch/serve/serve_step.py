"""Serving steps (the reference's ``serve/serve_step.py``, recsys part).

``recsys_score_step(cfg)`` scores a batch; ``recsys_retrieval_step(cfg, k)``
scores one user against C candidates and keeps the top k. Both return a
plain function of (model, batch[, cand_ids]) and run under
``torch.inference_mode()``. The ANN serve step and the LM steps are not
ported (ROADMAP Queue 1 items 8 and 10.6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import recsys


def recsys_score_step(cfg, lookup_fn=None) -> Callable:
    fam = recsys.family_of(cfg)

    @torch.inference_mode()
    def step(params, batch):
        return recsys.SCORE[fam](params, cfg, batch, lookup_fn)
    return step


def top_k(scores: torch.Tensor, k: int):
    """The k largest scores and their positions, ties by lower position
    (``lax.top_k``'s rule): a stable descending sort."""
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


def recsys_retrieval_step(cfg, k: int = 10, lookup_fn=None) -> Callable:
    """1 query x n_candidates scoring + top-k (the ANN-adjacent cell);
    ``family_of`` admits only two-tower so far."""
    recsys.family_of(cfg)

    @torch.inference_mode()
    def step(params, batch, cand_ids):
        cates = cand_ids % cfg.table_vocabs[3]
        scores = params.retrieval(batch, cand_ids, cates, lookup_fn)
        top, idx = top_k(scores, k)
        return top, cand_ids[idx]
    return step
