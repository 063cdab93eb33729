"""Black-box tuning launcher — the paper's §3.2 workflow as a CLI (the
reference's ``launch/tune.py``, its paper-pipeline and ``--spec`` modes).

    PYTHONPATH=src python -m repro_torch.launch.tune --n 2000 --dim 64 \
        --trials 15 --mode multi
    PYTHONPATH=src python -m repro_torch.launch.tune --spec "IVF64,Flat" \
        --n 2000 --dim 32 --trials 6 --mode single

Without ``--spec`` it tunes the paper's full pipeline (``AnnObjective``
over ``default_space``); with ``--spec`` it tunes a factory-built index's
``SearchParams`` (``SearchParamsObjective``, the space from the index's own
``search_params_space()``). Either way a TPE study runs and the launcher
prints the best trial (single) or the Pareto front (multi), then the build
log: what each trial paid for its graph (a structural build, a reprune
lookup or a cache hit).

The port runs on the card by default; ``--device cpu`` runs every kernel's
plain PyTorch version on the CPU instead (the counterpart of the
reference's platform choice). The defaults ``--finish-backend auto`` and,
at N >= 8192, ``--knn-backend auto`` resolve to the device finishing pass
and NN-Descent (with table-derived pools), as in the reference.
``--patience``, ``--eps`` and ``--compact-every`` set the serving knobs of
every trial (``--compact-every 8``: the compacted search); with ``--spec``
they, ``--dist-backend``, ``--rerank`` and ``--hop-backend`` override the
spec's build, as the reference's do.

``--shards`` with a graph-family ``--spec`` tunes a sharded deployment's
(graph_degree, alpha, ef_search): every shard builds once at the
structural maximum (``ShardedFactoryIndex``) and every degree/alpha trial
is a per-shard reprune — zero rebuilds, checked by the structural-build
counter in the last line. ``--shards`` without ``--spec`` shards the
paper's pipeline itself: a ``ShardedIndex`` over a mesh of the visible
devices when there are at least as many as shards, the host-offload
``StreamedShardedIndex`` otherwise (or with ``--offload``: shards stream
through the card one at a time, so N is bounded by host memory).
``--bench-build-out FILE`` merges the per-stage build timings (summed over
shards) into a ``BENCH_build.json``-style file as a
``stage="sharded_build"`` point:

    PYTHONPATH=src python -m repro_torch.launch.tune --spec NSG16 --shards 4
    PYTHONPATH=src python -m repro_torch.launch.tune --n 20000 --dim 768 \
        --shards 4 --trials 4
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.index_api import build_index
from repro_torch.core.pipeline import IndexParams
from repro_torch.core.pipeline import structural_build_count
from repro_torch.core.tuning import (
    AnnObjective, SearchParamsObjective, ShardedRepruneObjective, Study,
    TPESampler, default_space,
)
from repro_torch.data import clustered_vectors, queries_like


def merge_bench_point(path: str, point: dict, backend: str = "cuda") -> None:
    """Append one point to a ``BENCH_build.json``-style file in place.

    A point with the same (stage, n, shards, path) is replaced, so a re-run
    updates its own row; a missing or unreadable file starts a fresh
    document.
    """
    doc = {"backend": backend, "points": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            pass
    keyof = lambda p: (p.get("stage"), p.get("n"), p.get("shards"),
                       p.get("path"))
    doc["points"] = [p for p in doc.get("points", [])
                     if keyof(p) != keyof(point)] + [point]
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--mode", choices=["single", "multi"], default="multi")
    ap.add_argument("--recall-floor", type=float, default=0.9)
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the port runs: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--spec", default=None,
                    help="factory spec: tune SearchParams for this index "
                         "instead of the pipeline's build knobs")
    ap.add_argument("--shards", type=int, default=0,
                    help="with --spec on a graph family: shard the spec "
                         "and sweep (graph_degree, alpha, ef_search) via "
                         "per-shard reprune; without --spec: shard the "
                         "paper's pipeline (one structural build per shard, "
                         "everything else derived)")
    ap.add_argument("--offload", action="store_true",
                    help="with --shards (no --spec): force the host-offload "
                         "streamed tier even when there are enough devices "
                         "for the mesh")
    ap.add_argument("--bench-build-out", default=None,
                    help="with --shards (no --spec): merge a "
                         "stage='sharded_build' per-stage timing point "
                         "into this BENCH_build.json-style file")
    ap.add_argument("--knn-backend", default="auto",
                    choices=["exact", "nndescent", "auto"],
                    help="build-time kNN-graph backend (core.build): exact "
                         "O(N^2) pass, NN-Descent refinement, or auto by N")
    ap.add_argument("--finish-backend", default="auto",
                    choices=["host", "device", "auto"],
                    help="NSG finishing pass (build.finish): the host "
                         "interconnect + repair, or the device pass "
                         "(auto = device)")
    ap.add_argument("--max-degree", type=int, default=16,
                    help="structural graph-degree ceiling: the single real "
                         "build per structure happens here; degree/alpha "
                         "trials reprune down from it")
    ap.add_argument("--dist-backend", default=None,
                    choices=["f32", "pq", "int8"],
                    help="quantized-traversal serving (core.quant): adds "
                         "dist_backend + rerank to the tuned space (codes "
                         "encode once per structural build)")
    ap.add_argument("--rerank", type=int, default=None,
                    help="exact-rerank depth of the quantized beam tail "
                         "(IndexParams.rerank)")
    ap.add_argument("--hop-backend", default=None,
                    choices=["staged", "fused", "auto"],
                    help="beam-hop serving backend (core.beam_search): the "
                         "knob is tuned (it is in default_space); this "
                         "pins the base value")
    ap.add_argument("--patience", type=int, default=None,
                    help="adaptive early-termination hops (core.beam_search"
                         " straggler control): a lane stops after this many "
                         "hops without top-k progress > --eps; 0 = stock "
                         "convergence. The knob is tuned (it is in "
                         "default_space); this pins its base value")
    ap.add_argument("--eps", type=float, default=None,
                    help="top-k improvement threshold that counts as "
                         "progress for --patience (squared-L2 units)")
    ap.add_argument("--compact-every", type=int, default=None,
                    help="active-query compaction slice length: gather "
                         "surviving lanes into a smaller pow2 bucket every "
                         "this many hops (0 = the plain batched search)")
    ap.add_argument("--pca-dim", type=int, default=None,
                    help="pipeline PCA target dim (default: --dim, i.e. "
                         "projection off)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    data = clustered_vectors(torch.Generator(device=dev).manual_seed(0),
                             args.n, args.dim, n_clusters=32)
    queries = queries_like(torch.Generator(device=dev).manual_seed(1), data,
                           args.queries)
    b0 = structural_build_count()
    if args.spec and args.shards > 1:
        obj = _sharded_spec_objective(args, data, queries, dev)
    elif args.spec:
        obj = _spec_objective(args, data, queries, dev)
    elif args.shards > 1:
        obj = _sharded_pipeline_objective(args, data, queries, dev)
    else:
        obj, space = _pipeline_objective(args, data, queries, dev)
        _run_study(args, obj, space)
        return
    _run_study(args, obj, obj.space)
    if args.shards > 1:
        built = structural_build_count() - b0
        print(f"sharded sweep: {built} structural builds for "
              f"{args.shards} shards "
              f"({'OK — one per shard' if built == args.shards else 'REBUILD LEAK'})")


def _sharded_spec_objective(args, data, queries, dev):
    """The spec row-sharded (``ShardedFactoryIndex``), swept by per-shard
    reprune (``ShardedRepruneObjective``)."""
    from repro_torch.core.distributed import ShardedFactoryIndex
    idx = ShardedFactoryIndex(args.spec, n_shards=args.shards,
                              knn_backend=args.knn_backend,
                              finish_backend=args.finish_backend,
                              dist_backend=args.dist_backend,
                              rerank=args.rerank,
                              hop_backend=args.hop_backend,
                              patience=args.patience, eps=args.eps,
                              compact_every=args.compact_every,
                              device=dev).fit(
        data, generator=torch.Generator().manual_seed(0))
    return ShardedRepruneObjective(idx, data, queries, k=10,
                                   recall_floor=args.recall_floor,
                                   qps_repeats=3)


def _sharded_pipeline_objective(args, data, queries, dev):
    """The paper's pipeline sharded: a mesh ``ShardedIndex`` when the
    device type has at least ``--shards`` devices (and no ``--offload``),
    the host-offload ``StreamedShardedIndex`` otherwise; one structural
    build per shard, reprune-derived trials."""
    from repro_torch.core.distributed import (
        ShardedIndex, StreamedShardedIndex,
    )
    from repro_torch.launch.mesh import make_host_mesh
    p = IndexParams(pca_dim=args.pca_dim or args.dim,
                    graph_degree=args.max_degree,
                    build_knn_k=args.max_degree,
                    build_candidates=2 * args.max_degree, ef_search=64,
                    knn_backend=args.knn_backend,
                    finish_backend=args.finish_backend)
    n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    if not args.offload and n_devices >= args.shards:
        mesh = make_host_mesh(model=args.shards)
        idx = ShardedIndex(p, mesh).fit(data, generator=gen)
        path_name = "spmd"
    else:
        idx = StreamedShardedIndex(p, n_shards=args.shards,
                                   device=dev).fit(data, generator=gen)
        path_name = "streamed"
    synchronize(dev)
    build_seconds = time.perf_counter() - t0
    stats = idx.shard_stats
    agg = {f: round(sum(s[f] for s in stats), 3)
           for f in ("knn_seconds", "pools_seconds", "prune_seconds",
                     "finish_seconds")}
    print(f"sharded build ({path_name}): {args.shards} shards, "
          f"{build_seconds:.1f}s total "
          + " ".join(f"{k_}={v}" for k_, v in agg.items()))
    if args.bench_build_out:
        merge_bench_point(args.bench_build_out, {
            "n": args.n, "dim": args.dim, "stage": "sharded_build",
            "shards": args.shards, "path": path_name,
            "degree": args.max_degree, "knn_backend": args.knn_backend,
            "seconds": round(build_seconds, 3), **agg,
        }, backend=dev.type)
        print(f"merged sharded_build point into {args.bench_build_out}")
    return ShardedRepruneObjective(idx, data, queries, k=10,
                                   recall_floor=args.recall_floor,
                                   qps_repeats=3)


def _spec_objective(args, data, queries, dev):
    """SearchParamsObjective over the spec's index; a serving override
    builds it through ``build_index`` with the overrides, as the
    reference's does."""
    gen = torch.Generator().manual_seed(0)
    index = args.spec
    if (args.dist_backend is not None or args.rerank is not None
            or args.hop_backend is not None
            or args.patience is not None or args.eps is not None
            or args.compact_every is not None):
        index = build_index(args.spec, data, generator=gen, device=dev,
                            knn_backend=args.knn_backend,
                            finish_backend=args.finish_backend,
                            dist_backend=args.dist_backend,
                            rerank=args.rerank,
                            hop_backend=args.hop_backend,
                            patience=args.patience, eps=args.eps,
                            compact_every=args.compact_every)
    return SearchParamsObjective(index, data, queries, k=10,
                                 recall_floor=args.recall_floor,
                                 qps_repeats=3, generator=gen, device=dev)


def _pipeline_objective(args, data, queries, dev):
    quantized = args.dist_backend is not None or args.rerank is not None
    base = IndexParams(pca_dim=args.pca_dim or args.dim,
                       graph_degree=args.max_degree,
                       build_knn_k=args.max_degree,
                       build_candidates=2 * args.max_degree,
                       ef_search=64, knn_backend=args.knn_backend,
                       finish_backend=args.finish_backend,
                       dist_backend=args.dist_backend or "f32",
                       rerank=args.rerank if args.rerank is not None else 64,
                       hop_backend=args.hop_backend or "auto",
                       patience=args.patience or 0,
                       eps=args.eps or 0.0,
                       compact_every=args.compact_every or 0)
    obj = AnnObjective(data, queries, k=10, base_params=base,
                       recall_floor=args.recall_floor, qps_repeats=3,
                       device=dev)
    space = default_space(args.dim, args.n, max_degree=args.max_degree,
                          quantized=quantized)
    return obj, space


def _run_study(args, obj, space) -> None:
    if args.mode == "single":
        study = Study(space, TPESampler(seed=0, n_startup=5))
        study.optimize(obj.single_objective, n_trials=args.trials,
                       timeout=args.timeout)
        results = [study.best_trial]
    else:
        study = Study(space, TPESampler(seed=0, n_startup=5),
                      n_objectives=2)
        study.optimize(obj.multi_objective, n_trials=args.trials,
                       timeout=args.timeout)
        results = study.pareto_front()

    print(f"\n{'params':60s} recall   qps")
    for t in sorted(results, key=lambda t: -t.values[0]):
        r = t.user_attrs["result"]
        print(f"{str(t.params):60s} {r.recall:.4f}  {r.qps:.0f}")

    # build-cache efficacy: what each trial actually paid for its graph
    print(f"\n-- build log ({len(obj.eval_log)} evals) --")
    for i, (params, r) in enumerate(obj.eval_log):
        if not r.cached_build:
            tag = "full-build"
        elif r.repruned:
            tag = "reprune"
        else:
            tag = "cached"
        print(f"trial {i:02d} {tag:10s} build={r.build_seconds:6.2f}s "
              f"recall={r.recall:.4f} qps={r.qps:.0f} {params}")
    full = sum(1 for _, r in obj.eval_log if not r.cached_build)
    repr_ = sum(1 for _, r in obj.eval_log if r.cached_build and r.repruned)
    cached = len(obj.eval_log) - full - repr_
    print(f"{full} structural builds, {repr_} reprune derivations, "
          f"{cached} pure cache hits (the §5.3 rebuild cost fix)")
    if hasattr(obj, "grid_hits"):
        fam = getattr(obj, "family_prunes", getattr(obj, "reprunes", 0))
        print(f"reprune grid: {fam} family/derivation passes, "
              f"{obj.grid_hits} pure grid lookups")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"params": t.params, "values": t.values}
                       for t in results], f, indent=1)


if __name__ == "__main__":
    main()
