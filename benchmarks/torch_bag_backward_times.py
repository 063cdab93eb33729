#!/usr/bin/env python3
"""Times of embedding_bag's backward (the scatter behind ``segment_sum``
and the bag's table gradient) at its four path shapes on one NVIDIA card,
for any checkout of the port.

    python3 benchmarks/torch_bag_backward_times.py [--src DIR] [--seed 0]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so two commits compare in one call: unpack the other one
with ``git archive`` under ``build/`` and run both in turns (parent,
change, change, parent).

The shapes: DimeNet's ``agg`` (337,920 triplets into 168,960 edges by
``t_ji``, D = 128) and node readout (168,960 edges, 57% padding, into
171,008 nodes by ``dst``, D = 128) on minibatch_lg's batch, molecule's
graph readout (3,840 nodes into 128 graphs, D = 1), each from
``chip_smoke.gnn_batch(cell, --seed)`` with padding as -1, through
``segment_sum`` on normal data (a call allocates its zero output); and the
two-tower training step's table gradient (65,536 bags of 32 history ids
over the 14,010,368 x 256 table, mean) into one zero gradient, added into.

Per shape, ``ms`` is one event-timed call (host launch included, median of
10) and ``device_ms`` 8 calls queued behind a device sleep
(``chip_smoke.queued_ms``): ``with_grouping`` the call as the checkout's
callers make it without a plan (a sort, or the grouping kernel, inside);
where the checkout has ``bag_grouping_cuda``, ``grouping`` alone and
``planned``, the sum over a prepared plan (segment_sum's zero fill
included; store mode for the two-tower shape). Beside them the library
calls the port does not make: ``index_add_`` into ``torch.zeros`` over the
valid rows (F.embedding_bag's backward, its own zero fill included, at
the two-tower shape) and ``torch.sort(stable=True)`` of the flat ids. The
last lines are the card as nvidia-smi names it and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TABLE_ROWS, TABLE_DIM, BAG, BAGS = 14_010_368, 256, 32, 65_536
HISTORY = (10_000_000, 2_000_000)      # the history table's offset and vocab


def pair(torch, fn, queued_ms, time_ms) -> dict:
    """One event-timed call's ms and the queued device ms of ``fn``."""
    return {"ms": time_ms(fn, 10, 2), "device_ms": queued_ms(torch, fn,
                                                             calls=8)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_bag_backward_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import gnn_batch, gnn_kernel_cases, queued_ms, time_ms
    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import embedding_bag as bag

    cuda_lib.library()
    planned = hasattr(bag, "bag_grouping_cuda")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 2929)
    hosts = {cell: gnn_batch(cell, args.seed)
             for cell in ("minibatch_lg", "molecule")}
    out = {"src": args.src, "planned": planned}
    for name, cell, kernel, ids, segs, d in gnn_kernel_cases(
            get_arch("dimenet").config, hosts):
        if kernel != "embedding_bag_backward":
            continue
        ids = torch.from_numpy(ids).to(dev).int().contiguous()
        data = torch.randn((ids.shape[0], d), generator=g, device=dev)
        keep = ids >= 0
        lib_ids, lib_data = ids[keep].long(), data[keep].contiguous()
        r = {"cell": cell, "rows": ids.shape[0],
             "rows_valid": int(keep.sum()), "segments": segs, "d": d,
             "with_grouping": pair(torch, lambda: bag.segment_sum(
                 data, ids, segs), queued_ms, time_ms)}
        if planned:
            plan = bag.bag_grouping_cuda(ids, segs)
            r["grouping"] = pair(torch, lambda: bag.bag_grouping_cuda(
                ids, segs), queued_ms, time_ms)
            r["planned"] = pair(torch, lambda: bag.segment_sum(
                data, ids, segs, plan), queued_ms, time_ms)
        r["index_add"] = pair(torch, lambda: torch.zeros(
            (segs, d), device=dev).index_add_(0, lib_ids, lib_data),
            queued_ms, time_ms)
        r["torch_sort"] = pair(torch, lambda: torch.sort(ids, stable=True),
                               queued_ms, time_ms)
        out[name] = r
        del ids, data, lib_ids, lib_data
    torch.cuda.empty_cache()

    off, vocab = HISTORY
    ids = torch.randint(0, vocab, (BAGS, BAG), generator=g, device=dev,
                        dtype=torch.int32) + off
    grad = torch.randn((BAGS, TABLE_DIM), generator=g, device=dev)
    grad_out = torch.zeros((TABLE_ROWS, TABLE_DIM), device=dev)
    r = {"bags": BAGS, "l": BAG, "rows": TABLE_ROWS, "d": TABLE_DIM,
         "unique_rows": int(torch.unique(ids).numel()),
         "with_grouping": pair(torch, lambda: bag.embedding_bag_backward_cuda(
             grad, ids, None, "mean", grad_out), queued_ms, time_ms)}
    if planned:
        plan = bag.bag_grouping_cuda(ids, TABLE_ROWS)
        r["grouping"] = pair(torch, lambda: bag.bag_grouping_cuda(
            ids, TABLE_ROWS), queued_ms, time_ms)
        r["planned"] = pair(torch, lambda: bag.embedding_bag_backward_cuda(
            grad, ids, None, "mean", grad_out, plan, store=True), queued_ms,
            time_ms)
        del plan
    r["torch_sort"] = pair(torch, lambda: torch.sort(ids.reshape(-1),
                                                     stable=True),
                           queued_ms, time_ms)
    del grad_out
    table = torch.empty((TABLE_ROWS, TABLE_DIM), device=dev)
    table.normal_(generator=g)
    table.requires_grad_(True)
    lib_out = torch.nn.functional.embedding_bag(ids.long(), table,
                                                mode="mean")

    def library():
        return torch.autograd.grad(lib_out, table, grad, retain_graph=True)
    r["f_embedding_bag_backward"] = {"ms": time_ms(library, 5, 1),
                                     "device_ms": queued_ms(torch, library,
                                                            calls=3)}
    out["two_tower"] = r
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
