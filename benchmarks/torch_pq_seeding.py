#!/usr/bin/env python3
"""PQ codebook seeding on one NVIDIA card: k-means++ with one host round
trip per centroid against the port's batched, on-device seeding.

    python3 benchmarks/torch_pq_seeding.py [--seed 0]

The shapes are the quantized path's at ann-laion's widths: 300 sub-spaces
(``default_pq_m(600)``) of 2 dims over 270,000 rows, 256 centroids each.
It times:

* ``host_seeding_s``: the per-centroid seeding (each step copies the N
  distances to the host and draws there with ``torch.multinomial``) over
  ``HOST_SUBSPACES`` (8) sub-spaces, one after another;
* ``device_seeding_s``: ``repro_torch.core.kmeans.kmeanspp_init`` over all
  300 sub-spaces in one batched run;
* ``pq_fit_s``: ``PQCodec(300).fit`` (the batched seeding plus Lloyd per
  sub-space), the codec fit the quantized path runs.

``pq_fit_host_seeding_s`` is what the fit takes with the per-centroid
seeding: ``pq_fit_s - device_seeding_s + 300 * host_seeding_s /
HOST_SUBSPACES`` (the Lloyd iterations are the same code). The rows are
random clustered vectors from ``--seed``; k-means++ does the same work on
any rows of this shape. The last lines are the card as nvidia-smi names it
and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

N, DIM, M, C = 270_000, 600, 300, 256
HOST_SUBSPACES = 8      # the per-centroid seeding is timed on these alone


def host_seeding(torch, generator, x, k):
    """k-means++ as the port seeded before: one device-to-host copy of the
    N distances and one CPU draw per centroid."""
    from repro_torch.core.distances import pairwise_sqdist
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=generator))
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind = pairwise_sqdist(x[first][None, :], x)[0]
    for i in range(1, k):
        p = (mind / mind.sum().clamp_min(1e-12)).double().cpu()
        nxt = int(torch.multinomial(p, 1, generator=generator))
        cents[i] = x[nxt]
        mind = torch.minimum(mind, pairwise_sqdist(x[nxt][None, :], x)[0])
    return cents


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_pq_seeding: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core.device import resolve_device
    from repro_torch.core.kmeans import kmeanspp_init
    from repro_torch.core.quant import PQCodec
    from repro_torch.data import clustered_vectors

    dev = resolve_device()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = clustered_vectors(gen, N, DIM)
    sub = x.reshape(N, M, DIM // M).transpose(0, 1).contiguous()
    host_seeding(torch, torch.Generator().manual_seed(1), sub[0], 8)  # warm
    kmeanspp_init(torch.Generator().manual_seed(1), sub[:2], 8)
    torch.cuda.synchronize()

    t = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed)
    for j in range(HOST_SUBSPACES):
        host_seeding(torch, g, sub[j], C)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t

    t = time.perf_counter()
    kmeanspp_init(torch.Generator().manual_seed(args.seed), sub, C)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t

    t = time.perf_counter()
    PQCodec(M, C).fit(x, generator=torch.Generator().manual_seed(args.seed))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "n": N, "dim": DIM, "m": M,
        "c": C, "host_subspaces": HOST_SUBSPACES,
        "host_seeding_s": host_s,
        "host_seeding_per_subspace_s": host_s / HOST_SUBSPACES,
        "device_seeding_s": device_s, "pq_fit_s": fit_s,
        "pq_fit_host_seeding_s":
            fit_s - device_s + M * host_s / HOST_SUBSPACES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
