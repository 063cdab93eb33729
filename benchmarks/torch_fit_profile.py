"""Device-busy time of the configured ann-laion fit, on one card.

    python3 benchmarks/torch_fit_profile.py [--src DIR] [--seed 0]

Fits ``TunedGraphIndex`` with ``IndexParams.from_config(CONFIG)`` (its
own backends: NN-Descent, table pools, the device finish) on
``clustered_vectors(300000, 768)`` three times: once to warm up, once
timed on the host clock (``fit_wall_s``, with its stage seconds), and once
under ``torch.profiler`` (device activity only), whose kernels' durations
are summed (``device_kernel_s``; collecting ~800k kernel records takes
the profiler minutes). ``device_kernel_s / fit_wall_s`` is the card's busy
share of the fit; the profiled run's own wall time is longer (the
profiler's cost on the host) and is printed apart. ``same_graph`` checks
that the two timed fits built the same graph. ``--src`` is the ``src``
directory whose ``repro_torch`` is fitted (default: this checkout's). The
last lines are the card as nvidia-smi names it and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_fit_profile: no CUDA device visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.configs.ann_laion import CONFIG
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels import cuda_lib

    cuda_lib.library()
    data = clustered_vectors(
        torch.Generator(device="cuda").manual_seed(args.seed),
        CONFIG.n_database, CONFIG.dim)
    params = IndexParams.from_config(CONFIG)

    def fit():
        return TunedGraphIndex(params, device="cuda").fit(
            data, torch.Generator().manual_seed(args.seed))

    fit()                                                      # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    idx = fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        again = fit()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t
    device_us = sum(e.self_device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({
        "fit_wall_s": wall, "stage_seconds": idx.stage_seconds,
        "profiled_wall_s": wall_prof, "device_kernel_s": device_us / 1e6,
        "same_graph": bool(torch.equal(idx.graph.neighbors,
                                       again.graph.neighbors))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
