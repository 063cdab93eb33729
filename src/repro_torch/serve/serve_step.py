"""Serving steps (the reference's ``serve/serve_step.py``: the ANN and
recsys parts).

``ann_search_step(index, k)`` serves any ``core.index_api.Index``, with
optional bucketing and retries. ``recsys_score_step(cfg)`` scores a batch;
``recsys_retrieval_step(cfg, k)`` scores one user against C candidates and
keeps the top k. The recsys steps return a plain function of (model,
batch[, cand_ids]) and run under ``torch.inference_mode()``, the ANN
step under ``torch.no_grad()`` (an index may keep what a search makes). The
LM steps are not ported (ROADMAP Queue 1 item 10.6).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import recsys


def ann_search_step(index, k: int = 10, params=None, buckets=None,
                    retries: int = 0,
                    deadline_s: Optional[float] = None) -> Callable:
    """Serve cell for ANY ``core.index_api.Index`` conformer.

    The index and ``params`` (a ``SearchParams``) are fixed when the step is
    built. ``buckets`` (a sequence of batch sizes, e.g. ``pow2_buckets(64)``)
    wraps the step in ``serve.batching.BucketedSearch``: ragged request
    batches are padded to the nearest bucket, so mixed traffic reuses a
    small, warm set of shapes; call ``.warmup(index.dim)`` on the returned
    step before taking traffic. ``retries`` > 0 (or a ``deadline_s``) wraps
    it in ``serve.resilience.ResilientSearch`` — bounded retry with
    exponential backoff, failing fast on ``PermanentFault`` and past the
    deadline. The wrappers delegate attribute access, so bucketing and
    ``search_stats`` pass through.
    """
    @torch.no_grad()
    def step(queries):
        return index.search(queries, k, params)

    def search_stats():
        """Traversal stats of the step's most recent search (hops / wasted
        hops / active_fraction...), when the wrapped index exposes them."""
        fn = getattr(index, "search_stats", None)
        return fn() if fn is not None else None

    step.search_stats = search_stats
    out = step
    if buckets:
        from repro_torch.serve.batching import BucketedSearch
        out = BucketedSearch(out, buckets)
        out.search_stats = search_stats
    if retries > 0 or deadline_s is not None:
        from repro_torch.serve.resilience import ResilientSearch
        out = ResilientSearch(out, retries=retries, deadline_s=deadline_s)
    return out


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
