#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line:
  1. device   — refuses to run without CUDA; prints the card's name and
                power limit as nvidia-smi reports them.
  2. build    — builds the hand-written kernels (csrc/*.cu, nvcc, sm_90a).
  3. kernels  — runs gather_dist, beam_hop and topk_pool at the main path's
                shapes, holds each against its plain PyTorch version (exact
                on integer-valued inputs, within tolerance on float inputs)
                and times both with CUDA events.
  4. fit      — builds TunedGraphIndex with the ann-laion config
                (knn_backend="exact", finish_backend="host") on
                clustered_vectors(300000, 768) from --seed (the config's
                N and width; only the seed is an option).
  5. serve    — 1024 queries, k=10, ef=64, fused hop: QPS, recall@10 against
                the exact top-10 in the raw space, the hop counters, and the
                brute-force QPS.
  6. staged   — the same search with the staged hop must equal the fused one
                exactly (ids, dists, counters).
  7. reference — 256 of the queries searched again on the CPU, where every
                kernel runs its plain PyTorch version, must agree.
  8. the kernels line: launches on the main path (fit + serve), errors,
                times and bounds; every kernel must have launched.

Any failed check exits non-zero. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# Data-sheet peaks (NVIDIA H100 SXM, dense, without sparsity) of the one
# card this script's bounds were written for, under the name torch reports:
# (device-memory bytes/s, float32 operations/s outside the tensor cores).
PEAK_CARD = "NVIDIA H100 80GB HBM3"
PEAK_BW, PEAK_F32 = 3.35e12, 67e12

TOPK_SHAPE = dict(b=2048, m=96, k=64)      # NSG pool assembly
HOP_SHAPE = dict(q=1024, ef=64, r=32)      # one serving hop
SERVE_RUNS = 7                             # timed searches (median)
REF_QUERIES = 256                          # searched again on the CPU


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks(name: str):
    if name != PEAK_CARD:
        raise RuntimeError(f"no data-sheet peaks for {name!r}; bounds are "
                           f"known for {PEAK_CARD!r} only")
    return PEAK_BW, PEAK_F32


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, name: str):
    bw, flops = peaks(name)
    t_bytes, t_ops = bytes_moved / bw * 1e3, ops / flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


class Cycle:
    """Round-robin over input sets, so repeated timings do not find the
    previous call's rows in the 50 MB L2 cache."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def next(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def kernel_phase(torch, n: int, d: int, gpu: str, seed: int) -> dict:
    """Each kernel at the main path's shapes against its plain version."""
    from repro_torch.kernels.beam_hop import beam_hop_cuda, beam_hop_ref
    from repro_torch.kernels.gather_dist import gather_dist_cuda, \
        gather_dist_ref
    from repro_torch.kernels.topk_merge import topk_merge_cuda, \
        topk_pool_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    res = {}

    def ints(shape):
        return torch.randint(-8, 9, shape, generator=g, device=dev).float()

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def ids(shape, lo=-1):
        return torch.randint(lo, n, shape, generator=g, device=dev,
                             dtype=torch.int32)

    # -- gather_dist: the staged hop's (B, R) block over the projected base
    b, r = HOP_SHAPE["q"], HOP_SHAPE["r"]
    worst = 0.0
    for kind in ("int", "float"):
        db = ints((n, d)) if kind == "int" else randn((n, d))
        q = ints((b, d)) if kind == "int" else randn((b, d))
        idx = ids((b, r))
        got = gather_dist_cuda(q, db, idx)
        want = gather_dist_ref(q, db, idx)
        if kind == "int":
            if not torch.equal(got, want):
                raise AssertionError("gather_dist differs on integer data")
        else:
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)):
                raise AssertionError("gather_dist: +inf pattern differs")
            err = (got[fin] - want[fin]).abs()
            if not bool((err <= 1e-5 + 1e-5 * want[fin].abs()).all()):
                raise AssertionError("gather_dist beyond rtol=atol=1e-5")
            worst = float(err.max())
    sets = Cycle([ids((b, r)) for _ in range(8)])
    ms = time_ms(lambda: gather_dist_cuda(q, db, sets.next()))
    plain = time_ms(lambda: gather_dist_ref(q, db, sets.next()))
    uniq = sum(int(torch.unique(s[s >= 0]).numel()) for s in sets.items) / 8
    bmin, by = bound(uniq * d * 4 + b * d * 4 + b * r * 8, 3 * b * r * d,
                     gpu)
    res["gather_dist"] = dict(
        route="cuda", source="src/repro_torch/csrc/gather_dist.cu",
        replaces="src/repro/kernels/gather_dist/gather_dist.py:34",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bmin,
        bound_by=by, library_ms=None,
        shape=dict(b=b, r=r, d=d, n=n))

    # -- beam_hop: one serving hop of Q queries
    nq, ef = HOP_SHAPE["q"], HOP_SHAPE["ef"]

    def hop_inputs(kind):
        db = ints((n, d)) if kind == "int" else randn((n, d))
        q = ints((nq, d)) if kind == "int" else randn((nq, d))
        nbrs = ids((n, r))
        pool_i = ids((nq, ef))
        pool_d = torch.where(pool_i >= 0,
                             torch.randint(0, 2000, (nq, ef), generator=g,
                                           device=dev).float(),
                             float("inf")).sort(1).values
        pool_v = torch.rand((nq, ef), generator=g, device=dev) < 0.5
        # duplicates with the pool: some graph rows point at pool members
        sel = ids((nq,))
        return sel, nbrs, pool_i, pool_d, pool_v, q, db

    worst = 0.0
    for kind in ("int", "float"):
        args = hop_inputs(kind)
        sel, nbrs, pool_i = args[0], args[1], args[2]
        live = sel >= 0
        nbrs[sel[live].long(), :8] = pool_i[live, :8]
        got = beam_hop_cuda(*args)
        want = beam_hop_ref(*args)
        if kind == "int":
            for a_, b_ in zip(got, want):
                if not torch.equal(a_, b_):
                    raise AssertionError("beam_hop differs on integer data")
        else:
            fin = torch.isfinite(want[1])
            if not torch.equal(fin, torch.isfinite(got[1])):
                raise AssertionError("beam_hop: +inf pattern differs")
            err = (got[1][fin] - want[1][fin]).abs()
            if not bool((err <= 1e-5 + 1e-5 * want[1][fin].abs()).all()):
                raise AssertionError("beam_hop dists beyond rtol=atol=1e-5")
            # a near-tie may swap two entries of a row; where the ids agree,
            # the visited flags must agree too
            same = (got[0] == want[0]).all(1)
            if float(same.float().mean()) < 0.99 or not torch.equal(
                    got[3], want[3]):
                raise AssertionError("beam_hop ids/stats differ (float)")
            if not torch.equal(got[2][same], want[2][same]):
                raise AssertionError("beam_hop visited flags differ (float)")
            worst = float(err.max())
    sels = Cycle([ids((nq,)) for _ in range(8)])
    sel, nbrs, pool_i, pool_d, pool_v, q, db = args
    ms = time_ms(lambda: beam_hop_cuda(sels.next(), nbrs, pool_i, pool_d,
                                       pool_v, q, db))
    plain = time_ms(lambda: beam_hop_ref(sels.next(), nbrs, pool_i, pool_d,
                                         pool_v, q, db))
    gathered = 0.0
    for s in sels.items:
        rows = nbrs[s.clamp_min(0).long()][s >= 0]
        gathered += int(torch.unique(rows[rows >= 0]).numel()) / 8
    bmin, by = bound(gathered * d * 4 + nq * d * 4 + nq * r * 4
                     + 2 * nq * ef * 9 + nq * 12, 3 * nq * r * d, gpu)
    res["beam_hop"] = dict(
        route="cuda", source="src/repro_torch/csrc/beam_hop.cu",
        replaces="src/repro/kernels/beam_hop/beam_hop.py:117",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bmin,
        bound_by=by, library_ms=None,
        shape=dict(q=nq, ef=ef, r=r, d=d, n=n))

    # -- topk_pool: the NSG pool assembly (beam pool ∪ own kNN list)
    tb, tm, tk = TOPK_SHAPE["b"], TOPK_SHAPE["m"], TOPK_SHAPE["k"]

    def pool_inputs(kind):
        # ids repeat within a row; one id carries one distance per row
        idx = torch.randint(-1, 3 * tm, (tb, tm), generator=g, device=dev,
                            dtype=torch.int32)
        table = (torch.randint(0, 50, (tb, 3 * tm), generator=g,
                               device=dev).float() if kind == "int"
                 else torch.rand((tb, 3 * tm), generator=g, device=dev))
        ds = torch.where(idx >= 0, table.gather(1, idx.clamp_min(0).long()),
                         float("inf"))
        return idx, ds

    worst = 0.0
    for kind in ("int", "float"):
        idx, ds = pool_inputs(kind)
        gi, gd, _ = topk_merge_cuda(idx, ds, None, tk, merge=False)
        wi, wd = topk_pool_ref(idx, ds, tk)
        if not (torch.equal(gi, wi) and torch.equal(gd, wd)):
            raise AssertionError(f"topk_pool differs ({kind} data)")
        fin = torch.isfinite(wd)
        if bool(fin.any()):
            worst = max(worst, float((gd[fin] - wd[fin]).abs().max()))
    sets = Cycle([pool_inputs("float") for _ in range(8)])
    ms = time_ms(lambda: topk_merge_cuda(*sets.next(), None, tk,
                                         merge=False))
    plain = time_ms(lambda: topk_pool_ref(*sets.next(), tk))
    p = 128
    compares = tb * 2 * (p // 2) * 7 * 8 // 2
    bmin, by = bound(tb * tm * 8 + tb * tk * 8, compares, gpu)
    res["topk_merge"] = dict(
        route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
        replaces="src/repro/kernels/topk_merge/topk_merge.py:86",
        max_abs_err=worst, ms=ms, plain_ms=plain, bound_ms=bmin,
        bound_by=by, library_ms=None, shape=dict(b=tb, m=tm, k=tk))
    return res


def profile_busy(torch, fn) -> dict:
    """Device-busy milliseconds of one ``fn()`` call from a torch.profiler
    trace (kernels on one stream do not overlap, so their durations add),
    with the kernels that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    busy_ms = sum(v[0] for v in by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"device_busy_ms": busy_ms if by_name else None,
            "profiled_wall_ms": wall * 1e3,
            "top_kernels": [{"name": n[:60], "ms": v[0] / 1e3, "count": v[1]}
                            for n, v in top]}


def recall_at_k(found, truth) -> float:
    hits = sum(len(set(a) & set(b)) for a, b in zip(found.tolist(),
                                                     truth.tolist()))
    return hits / truth.numel()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gpu = torch.cuda.get_device_name(0)
    emit("device", kind=gpu, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    peaks(gpu)                  # the bounds need this card's data sheet

    # 2. build the kernels
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=lib.build_seconds, ptxas=ptxas)

    # 3. kernels at the main path's shapes, against their plain versions
    from repro_torch.configs.ann_laion import ANN_SHAPES, CONFIG
    n, n_queries = CONFIG.n_database, ANN_SHAPES["search_300k"].batch
    n_kept = max(1, math.ceil(CONFIG.antihub_keep * n))     # as antihub does
    t = time.perf_counter()
    kernels = kernel_phase(torch, n_kept, CONFIG.pca_dim, gpu, args.seed)
    torch.cuda.synchronize()
    emit("kernels", seconds=time.perf_counter() - t, kernels=kernels)

    # 4-5. the main path: fit, then serve — launch counts from these only
    from repro_torch.core.distances import l2_topk
    from repro_torch.core.build.finish import reachable_from
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    from repro_torch.data import clustered_vectors, queries_like
    from repro_torch.kernels.beam_hop import beam_hop_cuda
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    from repro_torch.kernels.topk_merge import topk_merge_cuda
    wrappers = {"gather_dist": gather_dist_cuda, "beam_hop": beam_hop_cuda,
                "topk_merge": topk_merge_cuda}

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    data = clustered_vectors(gen, n, CONFIG.dim)
    queries = queries_like(gen, data, n_queries)
    params = IndexParams.from_config(CONFIG, knn_backend="exact",
                                     finish_backend="host")
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    index = TunedGraphIndex(params, device="cuda").fit(
        data, torch.Generator().manual_seed(args.seed))
    fit_s = time.perf_counter() - t
    nbrs = index.graph.neighbors
    reach = reachable_from(nbrs.cpu().numpy(), int(index.graph.medoid))
    degree_ok = bool(((nbrs >= 0).sum(1) <= params.graph_degree).all())
    bs = index.build_stats
    emit("fit", seconds=fit_s, n=n, n_kept=index.ntotal,
         dim=CONFIG.dim, pca_dim=params.pca_dim,
         stage_seconds=index.stage_seconds,
         reachable=float(reach.mean()), degree_ok=degree_ok,
         pool_evals=bs.pool_evals, prune_evals=bs.prune_evals,
         repair_rounds=bs.repair_rounds,
         memory_bytes=index.memory_bytes(),
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if index.ntotal != n_kept:
        raise AssertionError(f"fit kept {index.ntotal} rows; the kernel "
                             f"phase ran at {n_kept}")
    if not reach.all() or not degree_ok:
        raise AssertionError("graph not reachable from the medoid, or a "
                             "row exceeds the degree")

    k, ef = CONFIG.k, CONFIG.ef_search
    index.search(queries, k, ef=ef, hop_backend="fused")       # warm
    serve_times = []
    for _ in range(SERVE_RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_f, i_f = index.search(queries, k, ef=ef, hop_backend="fused")
        torch.cuda.synchronize()
        serve_times.append(time.perf_counter() - t)
    serve_s = statistics.median(serve_times)
    stats_f = index.search_stats()
    launches = {name: w.launches for name, w in wrappers.items()}

    l2_topk(queries, data, k)                                   # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, true_i = l2_topk(queries, data, k)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t
    recall = recall_at_k(i_f.cpu(), true_i.cpu())
    # every lane rides every loop iteration: hops + wasted is the same for
    # all of them
    iters = (stats_f["hops"] + stats_f["wasted_hops"]) / n_queries
    prof = profile_busy(torch, lambda: index.search(queries, k, ef=ef,
                                                    hop_backend="fused"))
    busy = prof["device_busy_ms"]
    emit("serve", queries=n_queries, k=k, ef=ef, runs=SERVE_RUNS,
         qps=n_queries / serve_s,
         qps_min=n_queries / max(serve_times),
         qps_max=n_queries / min(serve_times), seconds=serve_s,
         recall_at_10=recall, stats=stats_f,
         loop_iterations=iters, ms_per_iteration=serve_s * 1e3 / iters,
         device_busy_share=None if busy is None else
         busy / (serve_s * 1e3), profile=prof,
         brute_force_qps=n_queries / brute_s)
    if not (torch.isfinite(d_f).all() and i_f.shape == (n_queries, k)):
        raise AssertionError("search returned non-finite or mis-shaped "
                             "results")
    if recall < 0.80:
        raise AssertionError(f"recall@10 {recall} below the 0.80 floor")

    # 6. staged hop == fused hop, bit for bit
    d_s, i_s = index.search(queries, k, ef=ef, hop_backend="staged")
    stats_s = index.search_stats()
    same = (torch.equal(d_s, d_f) and torch.equal(i_s, i_f)
            and stats_s == stats_f)
    emit("staged", equal_to_fused=same, stats=stats_s)
    if not same:
        raise AssertionError("staged hop differs from the fused hop")

    # 7. a small input against the plain PyTorch versions, on the CPU: the
    # same index, REF_QUERIES queries (lanes do not interact, so a subset
    # of the batch has the same results). Dists to rtol = atol = 1e-5 (the
    # reduction order over D differs), ids on >= 99% of rows.
    cpu_index = TunedGraphIndex.from_state(index.state_dict(), device="cpu")
    nq = min(REF_QUERIES, n_queries)
    d_c, i_c = cpu_index.search(queries[:nq].cpu(), k, ef=ef,
                                hop_backend="fused")
    rows = float((i_c == i_f[:nq].cpu()).all(1).float().mean())
    close = torch.allclose(d_c, d_f[:nq].cpu(), rtol=1e-5, atol=1e-5)
    emit("reference", queries=nq, ids_equal_rows=rows, dists_close=close,
         max_abs_err=float((d_c - d_f[:nq].cpu()).abs().max()))
    if rows < 0.99 or not close:
        raise AssertionError("the card's search disagrees with the plain "
                             "PyTorch versions on the CPU")

    # 8. the kernels line
    line = []
    for name, info in kernels.items():
        info = {k_: v for k_, v in info.items() if k_ != "shape"}
        line.append({"name": name, **info, "launches": launches[name]})
    print(json.dumps({"kernels": line}), flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:     # a failed phase: report, exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
