#!/usr/bin/env python3
"""Device times of the port's l2topk and embedding_bag kernels at the main
path's shapes, on one NVIDIA card, for any checkout of the port.

    python3 benchmarks/torch_kernel_times.py [--src DIR] [--seed 0]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two commits compare in one call: unpack the other one
with ``git archive`` under ``build/`` and run both in turns (parent,
change, change, parent).

l2topk runs at ``chip_smoke.l2topk_shapes()`` on random normal rows:
``ms`` is one event-timed call (host launch included; median of 25, of 5
above 1e11 multiply-adds), ``device_ms`` 16 calls queued behind a device
sleep (``chip_smoke.queued_ms``). Where the checkout routes l2topk by
shape, each shape also gives its variant and the device ms of every other
variant that takes it (``alt_device_ms``), the measurement behind the
route. embedding_bag runs at serve_p99 (B = 512), recsys_ann's 1024 queries
and serve_bulk (B = 262,144), L = 32, mean, over a 14,010,368 x 256 f32
table (the two-tower config's): ``device_ms`` cycles 8 id sets against the
50 MB L2, ``device_ms_l2_warm`` repeats one, ``library_device_ms`` is
torch's ``embedding_bag`` on the same cycle. The last lines are the card as
nvidia-smi names it and one JSON object.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TABLE_ROWS, TABLE_DIM, BAG = 14_010_368, 256, 32
HISTORY = (10_000_000, 2_000_000)      # the history table's offset and vocab
BAG_BATCHES = {"serve_p99": 512, "recsys_ann": 1024, "serve_bulk": 262_144}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import Cycle, l2topk_shapes, queued_ms, time_ms
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.l2topk import l2topk_cuda
    import repro_torch.kernels.l2topk.l2topk as l2mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.library()
    routed = "variant" in inspect.signature(l2topk_cuda).parameters
    g = torch.Generator(device="cuda").manual_seed(args.seed + 606)
    out = {"src": args.src, "l2topk": {}, "embedding_bag": {}}
    for name, (q, n, d, k) in l2topk_shapes().items():
        x = torch.randn((n, d), generator=g, device="cuda")
        qs = torch.randn((q, d), generator=g, device="cuda")
        reps, warm = (5, 1) if q * n * d > 1e11 else (25, 3)
        r = {"ms": time_ms(lambda: l2topk_cuda(qs, x, k), reps, warm),
             "device_ms": queued_ms(torch, lambda: l2topk_cuda(qs, x, k))}
        if routed:
            r["variant"] = l2mod.variant_for(q, n, d, min(k, n))
            r["alt_device_ms"] = {}
            for v in l2mod.VARIANTS:
                if v == r["variant"]:
                    continue
                try:
                    l2mod.route(q, n, d, min(k, n), 132, v)
                except ValueError:
                    continue                     # the variant refuses it
                r["alt_device_ms"][v] = queued_ms(
                    torch, lambda: l2topk_cuda(qs, x, k, variant=v))
        out["l2topk"][name] = r
        del x, qs
    torch.cuda.empty_cache()

    table = torch.empty((TABLE_ROWS, TABLE_DIM), device="cuda")
    table.normal_(generator=g)
    off, vocab = HISTORY
    for name, b in BAG_BATCHES.items():
        sets = Cycle([torch.randint(0, vocab, (b, BAG), generator=g,
                                    device="cuda", dtype=torch.int32) + off
                      for _ in range(8)])
        longs = Cycle([s.long() for s in sets.items])
        out["embedding_bag"][name] = {
            "device_ms": queued_ms(torch, lambda: embedding_bag_cuda(
                table, sets.next(), None, "mean")),
            "device_ms_l2_warm": queued_ms(torch, lambda: embedding_bag_cuda(
                table, sets.items[0], None, "mean")),
            "library_device_ms": queued_ms(
                torch, lambda: torch.nn.functional.embedding_bag(
                    longs.next(), table, mode="mean"))}
        del sets, longs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
