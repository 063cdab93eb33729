"""Synthetic LAION-like vectors, LM and recsys batches and random graphs
(the reference's ``data/synthetic.py`` recipes, drawn from a
``torch.Generator``).

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


def lm_batch(generator: torch.Generator, batch: int, seq_len: int,
             vocab: int) -> dict:
    """Uniform int32 token ids (B, S) and labels rolled by -1 along S (the
    last label wraps around; ``lm_loss`` masks it)."""
    tokens = torch.randint(0, vocab, (batch, seq_len), generator=generator,
                           device=generator.device, dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def recsys_batch(generator: torch.Generator, batch: int, cfg) -> dict:
    """Categorical ids per table (+ dense features / behaviour sequences),
    with the reference's distributions: uniform int32 ids per table with
    the config's ``multi_hot`` bag sizes, standard-normal dense features,
    for SASRec and DIN (``self-attn-seq`` / ``target-attn``) a (B, S)
    ``history`` of uniform item ids, a ``history_len`` uniform in [1, S]
    and a uniform ``target`` item, and Bernoulli(0.3) labels."""
    dev = generator.device
    multi_hot = cfg.multi_hot or (1,) * cfg.n_sparse

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev,
                             dtype=torch.int32)

    out = {"sparse_ids": [ints(0, vocab, (batch, bag))
                          for vocab, bag in zip(cfg.table_vocabs,
                                                multi_hot)]}
    if cfg.n_dense:
        out["dense"] = torch.randn((batch, cfg.n_dense), generator=generator,
                                   device=dev)
    if cfg.seq_len and cfg.interaction in ("self-attn-seq", "target-attn"):
        out["history"] = ints(0, cfg.table_vocabs[0], (batch, cfg.seq_len))
        out["history_len"] = ints(1, cfg.seq_len + 1, (batch,))
        out["target"] = ints(0, cfg.table_vocabs[0], (batch,))
    out["label"] = (torch.rand((batch,), generator=generator, device=dev)
                    < 0.3).float()
    return out


def random_graph(generator: torch.Generator, n_nodes: int, n_edges: int,
                 d_feat: int = 0, positions: bool = False) -> dict:
    """Random directed graph (edge_index src->dst) with optional features,
    with the reference's distributions: src uniform in [0, n), dst = (src
    + 1 + r) % n with r uniform in [0, n - 2] (no self-loops), int32
    ids; standard-normal (n, d_feat) features ``x``; (n, 3) positions
    ``pos``, normal times 2."""
    dev = generator.device

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=generator, device=dev,
                             dtype=torch.int32)

    src = ints(n_nodes, (n_edges,))
    dst = (src + 1 + ints(n_nodes - 1, (n_edges,))) % n_nodes
    g = {"src": src, "dst": dst, "n_nodes": n_nodes}
    if d_feat:
        g["x"] = torch.randn((n_nodes, d_feat), generator=generator,
                             device=dev)
    if positions:
        g["pos"] = torch.randn((n_nodes, 3), generator=generator,
                               device=dev) * 2.0
    return g
