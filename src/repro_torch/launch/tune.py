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
spec's build, as the reference's do. ``--shards`` (ROADMAP Queue 1 item 9)
is not ported yet and raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.index_api import build_index
from repro_torch.core.pipeline import IndexParams
from repro_torch.core.tuning import (
    AnnObjective, SearchParamsObjective, Study, TPESampler, default_space,
)
from repro_torch.data import clustered_vectors, queries_like


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
                    help="sharded tuning (not ported yet: ROADMAP Queue 1 "
                         "item 9)")
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
    if args.shards > 1:
        raise NotImplementedError(
            "--shards: sharded indexes and ShardedRepruneObjective are not "
            "ported yet (ROADMAP Queue 1 item 9)")
    dev = resolve_device(args.device)
    data = clustered_vectors(torch.Generator(device=dev).manual_seed(0),
                             args.n, args.dim, n_clusters=32)
    queries = queries_like(torch.Generator(device=dev).manual_seed(1), data,
                           args.queries)
    if args.spec:
        obj = _spec_objective(args, data, queries, dev)
        space = obj.space
    else:
        obj, space = _pipeline_objective(args, data, queries, dev)
    _run_study(args, obj, space)


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
        print(f"reprune grid: {obj.family_prunes} family/derivation passes, "
              f"{obj.grid_hits} pure grid lookups")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"params": t.params, "values": t.values}
                       for t in results], f, indent=1)


if __name__ == "__main__":
    main()
