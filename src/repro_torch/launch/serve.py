"""Serving launcher: one batched request cycle per family (the reference's
``launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-1.5b|mistral-nemo-12b|qwen3-32b [--batch 8] \\
        [--tokens 16] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval|sasrec|din|dlrm-mlperf [--batch 8] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch ann-laion \\
        --spec "PCA32,NSG16,EP16" --ef 48 [--device cpu]

``--arch dimenet`` exits as the reference does: GNN serving is scoring,
which the training launcher runs.

The LM family builds the arch's smoke config from seed 0, prefills a
batch of 32-token prompts and decodes ``--tokens`` greedily, as the
reference does: its prefill sizes the cache to the prompt, so the decode
steps' cache writes fall past the end and are dropped (only the lengths
move). The recsys family builds the arch's smoke config from seed 0, scores one
batch and retrieves the top 5 of 512 candidates for one user. The ANN
family is served purely from a factory spec string — any index the
registry knows ("Flat", "IVF128", "IVFPQ64x16", "HNSW32", "NSG32,EP16",
with an optional "PCA<d>," prefix) — over 4,000 x 48 clustered vectors:
bucketed and micro-batched by default (``--buckets auto``), or one batch
(``--buckets off``); ``--snapshot DIR`` saves the built index,
``--restore DIR`` loads it instead of building (checksums verified,
invariants validated). ``--shards S`` row-shards the spec over S
sub-indexes (``ShardedFactoryIndex``) and ``--on-shard-error skip`` serves
past a failed shard, with a ``degraded:`` line when one was masked. Both
print the reference's lines. The port runs on the card by default;
``--device cpu`` runs the plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_batch, recsys_batch
from repro_torch.models import recsys, transformer
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step, \
    recsys_retrieval_step, recsys_score_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {list_archs()}")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16,
                    help="tokens decoded per request (lm family only)")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--spec", default="PCA32,NSG16,EP16",
                    help="ANN factory spec string (ann family only)")
    ap.add_argument("--ef", type=int, default=48,
                    help="SearchParams.ef_search override (ann family only)")
    ap.add_argument("--batch-window", type=float, default=0.0,
                    help="micro-batching window in seconds; 0 serves each "
                         "request batch immediately (ann family only)")
    ap.add_argument("--buckets", default="auto",
                    help="comma-separated batch-shape buckets, or 'auto' "
                         "for powers of two up to 8x --batch, or 'off' "
                         "(ann family only)")
    ap.add_argument("--knn-backend", default=None,
                    choices=["exact", "nndescent", "auto"],
                    help="override the build-time kNN-graph backend for "
                         "graph specs (ann family only); the spec's ,ND<K> "
                         "suffix is the in-grammar equivalent")
    ap.add_argument("--finish-backend", default=None,
                    choices=["host", "device", "auto"],
                    help="override the NSG finishing pass for graph specs "
                         "(ann family only)")
    ap.add_argument("--dist-backend", default=None,
                    choices=["f32", "pq", "int8"],
                    help="quantized-traversal serving for graph specs (ann "
                         "family only); ,PQ<m>x8 / ,SQ8 in-grammar")
    ap.add_argument("--rerank", type=int, default=None,
                    help="exact-rerank depth of the quantized beam tail "
                         "(ann family only); ,Rerank<k> in-grammar")
    ap.add_argument("--hop-backend", default=None,
                    choices=["staged", "fused", "auto"],
                    help="beam-hop serving backend for graph specs (ann "
                         "family only); ,HopFused / ,HopStaged in-grammar")
    ap.add_argument("--patience", type=int, default=None,
                    help="adaptive early termination for graph specs (ann "
                         "family only); ,Adapt<p> in-grammar")
    ap.add_argument("--eps", type=float, default=None,
                    help="minimum top-k distance improvement that counts as "
                         "progress for --patience (ann family only)")
    ap.add_argument("--compact-every", type=int, default=None,
                    help="re-pack surviving lanes into a smaller bucketed "
                         "batch every N hops (ann family only); "
                         ",Adapt<p>c<n> in-grammar")
    ap.add_argument("--snapshot", default=None, metavar="DIR",
                    help="save a checksummed index snapshot to DIR after "
                         "the build (core.persist.save_index; ann family "
                         "only)")
    ap.add_argument("--restore", default=None, metavar="DIR",
                    help="load the index from a snapshot DIR instead of "
                         "building (checksums verified + invariants "
                         "validated on load; ann family only)")
    ap.add_argument("--shards", type=int, default=0,
                    help="row-shard the spec over this many sub-indexes "
                         "(ShardedFactoryIndex; ann family only)")
    ap.add_argument("--on-shard-error", default="raise",
                    choices=["raise", "skip"],
                    help="sharded degraded-search policy (with --shards)")
    ap.add_argument("--retries", type=int, default=0,
                    help="bounded-retry attempts around each search flush "
                         "(serve.resilience.ResilientSearch; ann family "
                         "only)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-flush wall-clock deadline in seconds for "
                         "--retries (ann family only)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject seeded transient search faults at this "
                         "per-flush probability (resilience demo; ann "
                         "family only)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for --fault-rate's deterministic schedule")
    return ap


def serve_ann(args, dev: torch.device) -> None:
    """The reference's ANN branch: build (or restore) the spec's index,
    then serve batch * 16 queries and print QPS and recall@10."""
    from repro_torch.core.flat import FlatIndex, recall_at_k
    from repro_torch.core.index_api import SearchParams, build_index
    from repro_torch.core.persist import load_index, save_index
    from repro_torch.data import clustered_vectors, queries_like
    from repro_torch.serve.batching import MicroBatchQueue, pow2_buckets
    from repro_torch.serve.serve_step import ann_search_step

    data = clustered_vectors(torch.Generator(device=dev).manual_seed(0),
                             4000, 48, n_clusters=16)
    queries = queries_like(torch.Generator(device=dev).manual_seed(1), data,
                           args.batch * 16)
    if args.restore:
        t_load = time.perf_counter()
        idx = load_index(args.restore, device=dev)
        print(f"restored [{getattr(idx, 'spec', None) or args.spec}] from "
              f"{args.restore} in {time.perf_counter() - t_load:.2f}s "
              f"(checksums verified, invariants validated)")
        if hasattr(idx, "on_shard_error"):
            idx.on_shard_error = args.on_shard_error
    elif args.shards > 0:
        from repro_torch.core.distributed import ShardedFactoryIndex
        idx = ShardedFactoryIndex(args.spec, n_shards=args.shards,
                                  knn_backend=args.knn_backend,
                                  finish_backend=args.finish_backend,
                                  dist_backend=args.dist_backend,
                                  rerank=args.rerank,
                                  hop_backend=args.hop_backend,
                                  patience=args.patience, eps=args.eps,
                                  compact_every=args.compact_every,
                                  on_shard_error=args.on_shard_error,
                                  device=dev)
        idx.fit(data, generator=torch.Generator().manual_seed(0))
    else:
        idx = build_index(args.spec, data,
                          generator=torch.Generator().manual_seed(0),
                          device=dev,
                          knn_backend=args.knn_backend,
                          finish_backend=args.finish_backend,
                          dist_backend=args.dist_backend,
                          rerank=args.rerank,
                          hop_backend=args.hop_backend,
                          patience=args.patience,
                          eps=args.eps,
                          compact_every=args.compact_every)
    if args.snapshot:
        save_index(idx, args.snapshot)
        print(f"snapshot saved to {args.snapshot} "
              f"(restore with --restore {args.snapshot})")
    injector = None
    if args.fault_rate > 0.0:
        # deterministic fault-injection demo: transient faults fire UNDER
        # the retry wrapper, so --retries absorbs them; armed only after
        # warmup so the warm calls are fault-free
        from repro_torch.serve.faults import FaultInjector
        injector = FaultInjector(seed=args.fault_seed)
        idx = injector.wrap_index(idx)
    spec_label = getattr(idx, "spec", None) or args.spec
    if args.buckets == "off":
        buckets = None
    elif args.buckets == "auto":
        buckets = pow2_buckets(args.batch * 8)
    else:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    step = ann_search_step(idx, k=10,
                           params=SearchParams(ef_search=args.ef),
                           buckets=buckets,
                           retries=args.retries,
                           deadline_s=args.deadline)
    _, ti = FlatIndex(data).search(queries, 10)
    if buckets is None:
        t0 = time.perf_counter()
        if injector is not None:
            injector.transient_rate = args.fault_rate
        _, ids = step(queries)
        ids = ids.cpu()                         # waits for the device
        dt = time.perf_counter() - t0
        print(f"ann-laion [{spec_label}]: {queries.shape[0] / dt:.0f} "
              f"QPS, recall@10={recall_at_k(ids, ti):.4f}")
        return
    # bucketed serving: warm every bucket shape, then stream ragged
    # request batches through the micro-batching queue
    step.warmup(idx.dim)
    if injector is not None:
        injector.transient_rate = args.fault_rate   # arm AFTER warmup
    n_warm = len(step.dispatched)
    queue = MicroBatchQueue(step, window_s=args.batch_window)
    rng = np.random.default_rng(0)
    host_queries = queries.cpu().numpy()
    tickets, row = [], 0
    t0 = time.perf_counter()
    while row < queries.shape[0]:
        n = int(rng.integers(1, args.batch + 1))     # ragged arrivals
        n = min(n, queries.shape[0] - row)
        tickets.append((queue.submit(host_queries[row:row + n]), row, n))
        row += n
        queue.maybe_flush()
    queue.flush()
    dt = time.perf_counter() - t0
    ids = np.full((queries.shape[0], 10), -1, np.int64)
    failed_tickets = 0
    for ticket, start, n in tickets:
        res = queue.take(ticket)
        if res:                         # SearchFailure is falsy
            ids[start:start + n] = res[1]
        else:
            failed_tickets += 1
    shapes = sorted(set(step.dispatched[n_warm:]))
    print(f"ann-laion [{spec_label}] bucketed "
          f"(window={args.batch_window}s, buckets={list(step.buckets)}):"
          f" {queries.shape[0] / dt:.0f} QPS, "
          f"recall@10={recall_at_k(torch.from_numpy(ids), ti):.4f}, "
          f"served shapes={shapes} (all pre-warmed)")
    lat = queue.latency_stats()
    print(f"  latency p50={lat['p50_ms']:.2f}ms "
          f"p99={lat['p99_ms']:.2f}ms mean={lat['mean_ms']:.2f}ms "
          f"over {lat['served']} queries / {lat['flushes']} flushes, "
          f"batch occupancy={lat['mean_occupancy']:.2f}")
    if injector is not None:
        print(f"  faults: {injector.faults_raised} injected "
              f"(rate={args.fault_rate}, seed={args.fault_seed}), "
              f"{getattr(step, 'retries_used', 0)} absorbed by retry")
    if lat["errors"] or lat["retries"] or lat["shed"] or failed_tickets:
        print(f"  resilience: {failed_tickets} failed tickets, "
              f"{lat['errors']} error answers, {lat['retries']} flush "
              f"retries, {lat['shed']} shed "
              f"(every ticket answered: result or typed failure)")
    degraded = getattr(idx, "degraded_shards", 0)
    if degraded:
        print(f"  degraded: {degraded} shard(s) masked on the last "
              f"search (on_shard_error=skip)")


def serve_lm(args, cfg, dev: torch.device) -> None:
    """The reference's LM branch: prefill 32 tokens, decode greedily."""
    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    model = transformer.init_params(gen(), cfg)
    toks = lm_batch(gen(), args.batch, 32, cfg.vocab_size)["tokens"]
    prefill, decode = lm_prefill_step(cfg), lm_decode_step(cfg)
    t0 = time.perf_counter()
    last, cache = prefill(model, toks)
    out = [last.argmax(-1).to(torch.int32)]
    pos = torch.full((args.batch,), toks.shape[1], dtype=torch.int32,
                     device=dev)
    for _ in range(args.tokens - 1):
        logits, cache = decode(model, out[-1], cache, pos)
        out.append(logits.argmax(-1).to(torch.int32))
        pos = pos + 1
    out[-1].cpu()                               # waits for the device
    dt = time.perf_counter() - t0
    print(f"{args.arch}: prefill(32) + decode({args.tokens}) for "
          f"batch {args.batch} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")


def main(argv=None):
    args = _parser().parse_args(argv)
    spec = get_arch(args.arch)
    dev = resolve_device(args.device)
    if spec.family == "ann":
        serve_ann(args, dev)
        return
    cfg = spec.smoke_config
    if spec.family == "lm":
        serve_lm(args, cfg, dev)
        return
    if spec.family == "gnn":
        raise SystemExit("gnn serving = scoring; use launch/train.py")

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    params = recsys.INIT[recsys.family_of(cfg)](gen(), cfg)
    batch = recsys_batch(gen(), args.batch, cfg)
    s = recsys_score_step(cfg)(params, batch)
    b1 = recsys_batch(gen(), 1, cfg)
    top, ids = recsys_retrieval_step(cfg, k=5)(
        params, b1, torch.arange(512, dtype=torch.int32, device=dev))
    print(f"{args.arch}: scored batch {args.batch} "
          f"(mean {float(s.mean()):.4f}); retrieval "
          f"top5 ids {np.asarray(ids.cpu())}")


if __name__ == "__main__":
    main()
