"""The port's ann-laion build against the reference's, on the CPU.

    PYTHONPATH=src python benchmarks/torch_build_parity.py \\
        [--n 20000] [--dim 768] [--pca 600] [--ep 16] [--queries 256]

Both packages fit ``TunedGraphIndex`` on the same data (the reference's
``clustered_vectors``, 32 clusters, from ``--seed``) with the ann-laion
knobs (AntiHub 0.9, degree 32, kNN width 32, 64 candidates, ``--pca``,
``--ep`` entry points), once with the default backends (at N >= 8192:
NN-Descent for the AntiHub and structural tables with the subset reuse,
table pools, the device finish; each package with its own random draws)
and once with ``knn_backend="exact"``, ``finish_backend="host"``. Per
package and backend it prints one JSON line: the kNN table's recall
against the exact 32-NN of that package's projected base, recall@10 of
``--queries`` queries at ef = 64 against the exact top-10 in the raw
space, the NN-Descent ``BuildStats`` and the fit's seconds on this CPU.
The comparison is of the algorithm, not of any device: the card's
numbers come from ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build import knn_graph_recall
from repro.core.flat import FlatIndex, recall_at_k
from repro.core.knn_graph import knn_graph
from repro.core.pipeline import IndexParams as JaxIndexParams
from repro.core.pipeline import TunedGraphIndex as JaxTunedGraphIndex
from repro.data import clustered_vectors, queries_like
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--pca", type=int, default=600)
    ap.add_argument("--ep", type=int, default=16)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    data = clustered_vectors(jax.random.PRNGKey(args.seed), args.n,
                             args.dim, n_clusters=32)
    queries = queries_like(jax.random.PRNGKey(args.seed + 1), data,
                           args.queries)
    _, truth = FlatIndex(data).search(queries, 10)
    truth = np.asarray(truth)
    knobs = dict(pca_dim=args.pca, antihub_keep=0.9, ep_clusters=args.ep,
                 graph_degree=32, build_knn_k=32, build_candidates=64,
                 ef_search=64)
    for backends in ({}, dict(knn_backend="exact", finish_backend="host")):
        for package in ("reference", "port"):
            t = time.perf_counter()
            if package == "reference":
                idx = JaxTunedGraphIndex(JaxIndexParams(**knobs, **backends)
                                         ).fit(data)
                base, table = np.asarray(idx.base), np.asarray(idx.knn_ids)
                found = np.asarray(idx.search(queries, 10)[1])
                stats = None
            else:
                idx = TunedGraphIndex(IndexParams(**knobs, **backends),
                                      device="cpu").fit(
                    torch.from_numpy(np.array(data)))
                base, table = idx.base.numpy(), idx.knn_ids.numpy()
                found = idx.search(torch.from_numpy(np.array(queries)),
                                   10)[1].numpy()
                stats = {k: v._asdict() for k, v in idx.knn_stats.items()}
            fit_s = time.perf_counter() - t
            _, exact = knn_graph(jax.numpy.asarray(base), 32)
            print(json.dumps({
                "package": package, "backends": backends or "default",
                "n": args.n, "dim": args.dim, "pca": args.pca,
                "knn_table_recall": knn_graph_recall(table,
                                                     np.asarray(exact)),
                "recall_at_10": float(recall_at_k(found, truth)),
                "knn_stats": stats, "fit_seconds_cpu": fit_s}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
