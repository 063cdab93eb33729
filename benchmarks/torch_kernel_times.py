#!/usr/bin/env python3
"""Device times of the port's l2topk, embedding_bag, topk_merge, lut_dist,
gather_dist, beam_hop and alpha_scan kernels, and of one whole fused
search, at the main path's shapes, on one NVIDIA card, for any checkout of
the port.

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
route; a shape the checkout's l2topk refuses (k past its lists) gives
``refused``. embedding_bag runs at serve_p99 (B = 512), recsys_ann's 1024
queries and serve_bulk (B = 262,144), L = 32, mean, over a 14,010,368 x
256 f32 table (the two-tower config's): ``device_ms`` cycles 8 id sets
against the 50 MB L2, ``device_ms_l2_warm`` repeats one,
``library_device_ms`` is torch's ``embedding_bag`` on the same cycle.

gather_dist runs over a 270,000 x 600 f32 base (the projected ann-laion
base) at B = 1024, R = 32 with every id valid (the staged hop, seeding,
rerank) and at B = 2048, R = 32 with half the ids -1 (the alpha-scan mid
scan); beam_hop's one-hop entry at ``chip_smoke.HOP_SHAPE`` (random pools,
sel cycling 8 sets): ``ms`` one event-timed call, ``device_ms`` queued.
``search`` builds the exact 32-NN graph of that base (clustered rows from
``--seed``) and runs a fused f32 search of 1024 in-distribution queries at
ef = 64, k = 10 from random entry points: ``device_ms`` is the device-busy
time of one search (torch.profiler, ``chip_smoke.profile_busy``),
``wall_ms`` the median of 7 host-timed searches, with the kernels it
launched and the hop loop's host syncs where the checkout counts them.

``lut_loop`` runs the LUT-mode hop loop over the same graph and queries at
M = 300 (PQ, ``default_pq_m(600)``) and M = 600 (int8): codes and LUTs
from the port's codecs fitted on the base (PQ's seeds from ``--seed``).
Per width: ``device_ms`` of one ``beam_hops_lut_cuda`` call from the seeded
state (queued_ms), the fused search's device-busy and wall ms with its
search_stats, and, where the checkout routes the loop
(``beam_hop.route``), the plan and ``probes``: device ms of the same call
on the route's plan and on the designs it was chosen over: ``l2_only``
(nothing resident, the grid cut so that the live LUTs fit ``L2_SHARE`` of
the L2), ``l2_bounded`` (the route's residency, the grid cut so that the
live L2 parts fit that share) and ``per_query``, each equal to per_query's
outputs.

``topk_merge`` runs at ``chip_smoke.TOPK_SHAPES`` (the NSG pool assembly
B = 2048, M = 96, k = 64; the device finish's union, k = 96; NN-Descent's
merge, M = 116, k = 32, merge mode; the rest of the default fit's widths:
the random-projection joins M = 64 / 52, the subset seed M = 42, the
AntiHub table's rounds M = 80, the table pools M = 192, k = 64, pool mode)
on ``chip_smoke.topk_inputs`` float
rows cycling 8 sets, and ``lut_dist`` over 1024 queries' (M, 256) LUTs and
270,000 uniform code rows at M = 300 and 600 with R = 1 (the pool seed)
... 32 (the staged hop): ``device_ms`` (queued) of the checkout's own
call; where it routes the kernel (``route``), the variant it picks and the
device ms of every variant (``variants``), the measurements behind both
routes.

``alpha_scan`` runs at its three path shapes over a 270,000 x 600
clustered base (``--seed``), pools of 2048 nodes from their exact nearest
rows (``l2topk``; distance-ascending, the node itself first): the prune
stage (L = 64, alpha 1.2), the interconnect's re-prune (L = 96, 70% of the
64 reverse slots -1, alpha 1.2) and a reprune_family pass (the prune's
kept 32 as pools, 9 x 2048 rows, one alpha per row from the tuner's
grid 1.00 ... 1.40): ``device_ms`` (queued) of the checkout's own call and,
where it routes the kernel (``route``), its variant and each variant's
``variants`` device ms, with the kept count and a checksum of the masks.
The last lines are the card as nvidia-smi names it and one JSON object.
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
BASE = (270_000, 600)                  # the projected ann-laion base
GATHER_CALLS = {"staged_1024": (1024, 0.0), "alpha_scan_2048": (2048, 0.5)}


def hop_times(torch, g, seed: int) -> dict:
    """gather_dist, beam_hop's one-hop entry and a whole fused search."""
    import statistics
    import time
    from chip_smoke import HOP_SHAPE, Cycle, profile_busy, queued_ms, time_ms
    from repro_torch.core import beam_search as bs_mod
    from repro_torch.core.knn_graph import knn_graph
    from repro_torch.data import clustered_vectors, queries_like
    from repro_torch.kernels.beam_hop import beam_hop_cuda
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    import repro_torch.kernels.beam_hop as hop_mod

    n, d = BASE
    nq, ef, r = HOP_SHAPE["q"], HOP_SHAPE["ef"], HOP_SHAPE["r"]
    dev = "cuda"
    db = torch.randn((n, d), generator=g, device=dev)
    out = {"gather_dist": {}}
    for name, (b, pad) in GATHER_CALLS.items():
        q = torch.randn((b, d), generator=g, device=dev)

        def ids():
            i = torch.randint(0, n, (b, r), generator=g, device=dev,
                              dtype=torch.int32)
            return torch.where(torch.rand((b, r), generator=g, device=dev)
                               < pad, -1, i)
        sets = Cycle([ids() for _ in range(8)])
        out["gather_dist"][name] = {
            "ms": time_ms(lambda: gather_dist_cuda(q, db, sets.next())),
            "device_ms": queued_ms(torch, lambda: gather_dist_cuda(
                q, db, sets.next())),
            "valid_ids": float(sum(int((s_ >= 0).sum()) for s_ in sets.items)
                               / 8)}
    q = torch.randn((nq, d), generator=g, device=dev)
    nbrs = torch.randint(-1, n, (n, r), generator=g, device=dev,
                         dtype=torch.int32)
    pool_i = torch.randint(-1, n, (nq, ef), generator=g, device=dev,
                           dtype=torch.int32)
    pool_d = torch.where(pool_i >= 0, torch.randint(
        0, 2000, (nq, ef), generator=g, device=dev).float(),
        float("inf")).sort(1).values
    pool_v = torch.rand((nq, ef), generator=g, device=dev) < 0.5
    sels = Cycle([torch.randint(-1, n, (nq,), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(8)])
    hop = lambda: beam_hop_cuda(sels.next(), nbrs, pool_i, pool_d, pool_v, q,
                                db)
    out["beam_hop"] = {"ms": time_ms(hop),
                       "device_ms": queued_ms(torch, hop)}
    del db, q, nbrs, pool_i, pool_d, pool_v, sels
    torch.cuda.empty_cache()

    data = clustered_vectors(g, n, d)
    queries = queries_like(g, data, nq)
    _, graph = knn_graph(data, r)
    entry = torch.randint(0, n, (nq,), generator=g, device=dev,
                          dtype=torch.int32)
    search = lambda: bs_mod.beam_search(queries, data, graph, entry, ef=ef,
                                        k=10, hop_backend="fused",
                                        with_stats=True)
    search()
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        search()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    prof = profile_busy(torch, search)
    counters = [w for w in ("beam_hop_cuda", "beam_hops_cuda")
                if hasattr(hop_mod, w)]
    before = {w: getattr(hop_mod, w).launches for w in counters}
    syncs = getattr(bs_mod.beam_search, "host_syncs", None)
    _, ids, stats = search()
    torch.cuda.synchronize()
    out["search"] = {
        "device_ms": prof["device_busy_ms"],
        "device_kernels": prof.get("device_kernels"),
        "wall_ms": statistics.median(times) * 1e3,
        "wall_ms_min": min(times) * 1e3, "wall_ms_max": max(times) * 1e3,
        "launches": {w: getattr(hop_mod, w).launches - before[w]
                     for w in counters},
        "host_syncs": None if syncs is None else
        bs_mod.beam_search.host_syncs - syncs,
        "top_kernels": prof["top_kernels"],
        "stats": {f: int(getattr(stats, f).sum()) for f in stats._fields},
        "ids_checksum": int(ids.long().sum())}
    out["lut_loop"] = lut_loop_times(torch, data, queries, graph, entry,
                                     ef, seed)
    return out


def lut_loop_times(torch, data, queries, graph, entry, ef,
                   seed: int) -> dict:
    """The LUT loop at pq's and int8's widths over ``graph``; see the
    module docstring."""
    import importlib
    import statistics
    import time
    from chip_smoke import profile_busy, queued_ms
    from repro_torch.core import beam_search as bs_mod
    from repro_torch.core.quant import make_codec
    from repro_torch.kernels.lut_dist import lut_dist_cuda
    # the module (the package's name beam_hop is its dispatch function)
    bh = importlib.import_module("repro_torch.kernels.beam_hop.beam_hop")

    nq, r = queries.shape[0], graph.shape[1]
    out = {}
    for backend in ("pq", "int8"):
        codec = make_codec(backend, data.shape[1]).fit(
            data, generator=torch.Generator().manual_seed(seed))
        codes = codec.encode(data).contiguous()
        lut = codec.lut(queries).contiguous()
        m, c = lut.shape[1], lut.shape[2]
        state = bs_mod._seed_batched(
            lut, codes, graph, entry, ef,
            lambda q_, db_, ids: lut_dist_cuda(lut, codes, ids))
        call = lambda **kw: bh.beam_hops_lut_cuda(
            graph, *state[:6], state[7], lut, codes, k=10,
            max_iters=4 * ef, max_steps=4 * ef, **kw)
        res = {"m": m, "c": c, "device_ms": queued_ms(torch, call)}
        search = lambda: bs_mod.beam_search(
            queries, data, graph, entry, ef=ef, k=10, hop_backend="fused",
            dist_backend=backend, codes=codes, lut=lut, with_stats=True)
        search()
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            search()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = profile_busy(torch, search)
        _, ids, stats = search()
        res.update(search_device_ms=prof["device_busy_ms"],
                   search_wall_ms=statistics.median(times) * 1e3,
                   top_kernels=prof["top_kernels"],
                   stats={f: int(getattr(stats, f).sum())
                          for f in stats._fields},
                   ids_checksum=int(ids.long().sum()))
        if hasattr(bh, "route"):
            l2, sms = bh._card(codes.device)
            plan = bh.route(m, c, r, ef, l2, sms)
            res["plan"] = plan._asdict()
            share = int(bh.L2_SHARE * l2)
            l2_part = max(1, (m - plan.resident) * c * 4)
            plans = {"route": plan,
                     "l2_only": bh.LutPlan("persistent",
                                           max(1, share // (m * c * 4)), 0),
                     "l2_bounded": plan._replace(
                         grid=max(1, min(plan.grid, share // l2_part))),
                     "per_query": bh.LutPlan("per_query", 0, 0)}
            want = call(plan=plans["per_query"])
            res["probes"] = {}
            for name, p_ in plans.items():
                same = all(torch.equal(a, b)
                           for a, b in zip(call(plan=p_), want))
                res["probes"][name] = {
                    "plan": p_._asdict(), "equal_to_per_query": same,
                    "device_ms": queued_ms(torch, lambda: call(plan=p_),
                                           calls=4)}
        out[backend] = res
        del codec, codes, lut, state
        torch.cuda.empty_cache()
    return out


LUT_RS = (1, 2, 4, 8, 16, 32)          # pairs = 1024 R: the crossover sweep


def topk_lut_times(torch, g, n: int) -> dict:
    """topk_merge and lut_dist; see the module docstring."""
    import importlib
    from chip_smoke import (HOP_SHAPE, LUT_C, LUT_MS, TOPK_SHAPES, Cycle,
                            queued_ms, topk_inputs)
    tm = importlib.import_module("repro_torch.kernels.topk_merge.topk_merge")
    ld = importlib.import_module("repro_torch.kernels.lut_dist.lut_dist")
    out = {"topk_merge": {}, "lut_dist": {}}
    for name, shape in TOPK_SHAPES.items():
        k, merge = shape["k"], shape["merge"]
        sets = Cycle([topk_inputs(torch, g, shape, "float")
                      for _ in range(8)])
        call = lambda **kw: tm.topk_merge_cuda(*sets.next(), k, merge=merge,
                                               **kw)
        res = {"device_ms": queued_ms(torch, call)}
        if hasattr(tm, "route"):
            res["variant"] = tm.route(shape["m"])
            res["variants"] = {v: queued_ms(torch, lambda: call(variant=v))
                               for v in tm.VARIANTS}
        out["topk_merge"][name] = res
        del sets
    nq = HOP_SHAPE["q"]
    for m in LUT_MS:
        codes = torch.randint(0, LUT_C, (n, m), generator=g, device="cuda",
                              dtype=torch.uint8)
        lut = torch.rand((nq, m, LUT_C), generator=g, device="cuda")
        by_r = {}
        for r in LUT_RS:
            sets = Cycle([torch.randint(0, n, (nq, r), generator=g,
                                        device="cuda", dtype=torch.int32)
                          for _ in range(8)])
            call = lambda **kw: ld.lut_dist_cuda(lut, codes, sets.next(),
                                                 **kw)
            res = {"device_ms": queued_ms(torch, call)}
            if hasattr(ld, "route"):
                res["variant"] = ld.route(nq * r)
                res["variants"] = {v: queued_ms(torch, lambda: call(
                    variant=v)) for v in ld.VARIANTS}
            by_r[str(r)] = res
            del sets
        out["lut_dist"][str(m)] = by_r
        del codes, lut
    torch.cuda.empty_cache()
    return out


SCAN_NODES, SCAN_ALPHA = 2048, 1.2
SCAN_GRID = tuple(round(1.0 + 0.05 * i, 2) for i in range(9))


def alpha_scan_times(torch, g) -> dict:
    """alpha_scan at the prune, interconnect and family shapes; see the
    module docstring."""
    import importlib
    from chip_smoke import queued_ms
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda
    from repro_torch.kernels.gather_dist import gather_dist
    from repro_torch.kernels.l2topk import l2topk_cuda
    scan_mod = importlib.import_module(
        "repro_torch.kernels.alpha_scan.alpha_scan")

    n, d = BASE
    data = clustered_vectors(g, n, d)
    nodes = torch.randperm(n, generator=g, device="cuda")[:SCAN_NODES]
    nodes = nodes.to(torch.int32)
    near_d, near_i = l2topk_cuda(data[nodes.long()].contiguous(), data, 96)
    inter_i = near_i.clone()
    drop = torch.rand((SCAN_NODES, 64), generator=g, device="cuda") < 0.7
    inter_i[:, 32:][drop] = -1
    inter_d = torch.where(inter_i >= 0, near_d, float("inf"))
    order = torch.sort(inter_d, dim=1, stable=True).indices
    inter_i, inter_d = inter_i.gather(1, order), inter_d.gather(1, order)
    prune_i, prune_d = near_i[:, :64].contiguous(), \
        near_d[:, :64].contiguous()
    kept, _ = alpha_scan_cuda(data, nodes, prune_i, prune_d, 32, SCAN_ALPHA)
    fam_d = gather_dist(data[nodes.long()].contiguous(), data, kept)
    order = torch.sort(fam_d, dim=1, stable=True).indices
    fam_i, fam_d = kept.gather(1, order), fam_d.gather(1, order)
    grid = torch.tensor(SCAN_GRID, device="cuda").repeat_interleave(
        SCAN_NODES)
    calls = {
        "prune": (data, nodes, prune_i, prune_d, 32, SCAN_ALPHA),
        "interconnect": (data, nodes, inter_i.contiguous(),
                         inter_d.contiguous(), 32, SCAN_ALPHA),
        "reprune_family": (data, nodes.repeat(9), fam_i.repeat(9, 1),
                           fam_d.repeat(9, 1), 32, grid)}
    routed = hasattr(scan_mod, "route")
    out = {}
    for name, args in calls.items():
        keep, mask = alpha_scan_cuda(*args)
        r = {"device_ms": queued_ms(torch, lambda: alpha_scan_cuda(*args)),
             "kept": int((keep >= 0).sum()),
             "mask_checksum": int((mask.long() * torch.arange(
                 mask.shape[1], device="cuda")).sum())}
        if routed:
            b, l = args[2].shape
            r["variant"] = scan_mod.route(32, l, d)
            r["variants"] = {v: queued_ms(torch, lambda v=v: alpha_scan_cuda(
                *args, variant=v)) for v in scan_mod.VARIANTS}
        out[name] = r
    return out


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
    torch.set_float32_matmul_precision("highest")
    cuda_lib.library()
    routed = "variant" in inspect.signature(l2topk_cuda).parameters
    g = torch.Generator(device="cuda").manual_seed(args.seed + 606)
    out = {"src": args.src, "l2topk": {}, "embedding_bag": {}}
    for name, (q, n, d, k) in l2topk_shapes().items():
        x = torch.randn((n, d), generator=g, device="cuda")
        qs = torch.randn((q, d), generator=g, device="cuda")
        reps, warm = (5, 1) if q * n * d > 1e11 else (25, 3)
        try:
            l2topk_cuda(qs, x, k)
        except ValueError as exc:                # k past the checkout's
            out["l2topk"][name] = {"refused": str(exc)}
            del x, qs
            continue
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
    del table
    torch.cuda.empty_cache()
    out["alpha_scan"] = alpha_scan_times(torch, g)
    torch.cuda.empty_cache()
    out.update(topk_lut_times(torch, g, BASE[0]))
    out.update(hop_times(torch, g, args.seed))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
