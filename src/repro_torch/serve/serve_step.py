"""Serving steps (the reference's ``serve/serve_step.py``).

``ann_search_step(index, k)`` serves any ``core.index_api.Index``, with
optional bucketing and retries. ``recsys_score_step(cfg)`` scores a batch;
``recsys_retrieval_step(cfg, k)`` scores one user against C candidates and
keeps the top k. ``lm_prefill_step(cfg)`` runs a prompt and returns the
last position's logits with the cache, ``lm_decode_step(cfg)`` one token
on that cache (written in place). The recsys steps return a plain function
of (model, batch[, cand_ids]) and run under ``torch.inference_mode()``,
the ANN and LM steps under ``torch.no_grad()`` (an index may keep what a
search makes; the LM's cache outlives the step).

DIN and DLRM build a wide intermediate per scored row: DIN a (S, 8 d)
feature block per candidate ((1M, 100, 144) f32 is 57.6 GB at the full
config), DLRM 27 vectors per row and a 1024-wide top MLP. So the recsys
steps score in chunks of rows (``chunk_rows``: the rows whose
intermediates fit ``CHUNK_BYTES``), which changes no result: rows never
interact.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import recsys, transformer


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


def lm_prefill_step(cfg, mesh=None) -> Callable:
    """step(model, tokens, max_len=None) -> (logits (B, V) of the last
    position, cache). The reference takes ``prefill``'s (B, S, V) logits
    and keeps the last row; rows never interact, so the head is applied to
    the last position only (at 32k x 151,936 the whole would be 19.9 GB a
    sequence). Without ``max_len`` the cache holds the prompt exactly, as
    the reference's step. ``mesh``: the tensor-parallel prefill (``model``
    a ``ShardedLM``; the logits gathered over ``model``)."""
    @torch.no_grad()
    def step(model, tokens, max_len=None):
        x, cache = transformer.prefill_states(model, cfg, tokens, max_len,
                                              mesh)
        return transformer.logits_of(model, x[:, -1], mesh), cache
    return step


def lm_decode_step(cfg, mesh=None) -> Callable:
    """step(model, token, cache, pos) -> (logits (B, V), cache);
    ``mesh``: the tensor-parallel step on a ``ShardedKVCache``."""
    def step(model, token, cache, pos):
        return transformer.decode_step(model, cfg, token, cache, pos, mesh)
    return step


CHUNK_BYTES = 1 << 30        # one chunk's widest intermediates


def row_bytes(cfg) -> Optional[int]:
    """Bytes of the intermediates one scored row builds at once, for the
    families whose rows are wide (DIN, DLRM); None for the others."""
    fam = recsys.family_of(cfg)
    if fam == "din":
        d2 = 2 * cfg.embed_dim
        return 4 * cfg.seq_len * (6 * d2 + sum(cfg.attn_mlp))
    if fam == "dlrm-mlperf":
        return 4 * (3 * (cfg.n_sparse + 1) * cfg.embed_dim
                    + max(cfg.top_mlp + cfg.bot_mlp))
    return None


def chunk_rows(cfg) -> Optional[int]:
    """Rows per chunk: CHUNK_BYTES over ``row_bytes`` (None: no
    chunking)."""
    rb = row_bytes(cfg)
    return None if rb is None else max(1, CHUNK_BYTES // rb)


def _rows(batch, lo: int, hi: int):
    """Rows [lo, hi) of every per-row tensor of a batch."""
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [_rows(v, lo, hi) for v in batch]
    return batch[lo:hi]


def _chunked(fn, n: int, chunk: Optional[int]) -> torch.Tensor:
    """fn(lo, hi) over [0, n) in chunks of ``chunk`` rows, concatenated."""
    if chunk is None or n <= chunk:
        return fn(0, n)
    return torch.cat([fn(lo, min(lo + chunk, n))
                      for lo in range(0, n, chunk)])


def recsys_score_step(cfg, lookup_fn=None) -> Callable:
    """Scores of a batch, ``chunk_rows(cfg)`` rows at a time."""
    fam = recsys.family_of(cfg)
    rows = chunk_rows(cfg)

    @torch.inference_mode()
    def step(params, batch):
        n = batch["sparse_ids"][0].shape[0]
        return _chunked(lambda lo, hi: recsys.SCORE[fam](
            params, cfg, _rows(batch, lo, hi), lookup_fn), n, rows)
    return step


def top_k(scores: torch.Tensor, k: int):
    """The k largest scores and their positions, ties by lower position
    (``lax.top_k``'s rule): a stable descending sort."""
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


def recsys_retrieval_step(cfg, k: int = 10, lookup_fn=None) -> Callable:
    """1 query x n_candidates scoring + top-k (the ANN-adjacent cell), per
    family as the reference's step: two-tower and SASRec score the user's
    vector against the candidates' embeddings, DIN lets every candidate
    attend the history, and DLRM scores the user's context with its first
    sparse feature set to each candidate. DIN and DLRM run over chunks of
    ``chunk_rows(cfg)`` candidates."""
    fam = recsys.family_of(cfg)
    rows = chunk_rows(cfg)

    def dlrm_scores(params, batch, cand_ids):
        c = cand_ids.shape[0]
        bb = {key: ([x[:1].expand((c,) + tuple(x.shape[1:])) for x in v]
                    if isinstance(v, list)
                    else v[:1].expand((c,) + tuple(v.shape[1:])))
              for key, v in batch.items()}
        sparse = list(bb["sparse_ids"])
        sparse[0] = (cand_ids[:, None] % cfg.table_vocabs[0]).to(
            torch.int32)
        return params(dict(bb, sparse_ids=sparse), lookup_fn)

    @torch.inference_mode()
    def step(params, batch, cand_ids):
        if fam == "two-tower-retrieval":
            cates = cand_ids % cfg.table_vocabs[3]
            scores = params.retrieval(batch, cand_ids, cates, lookup_fn)
        elif fam == "sasrec":
            scores = params.retrieval(batch, cand_ids, lookup_fn)
        elif fam == "din":
            scores = _chunked(lambda lo, hi: params.retrieval(
                batch, cand_ids[lo:hi], lookup_fn), cand_ids.shape[0], rows)
        else:
            scores = _chunked(lambda lo, hi: dlrm_scores(
                params, batch, cand_ids[lo:hi]), cand_ids.shape[0], rows)
        top, idx = top_k(scores, k)
        return top, cand_ids[idx]
    return step
