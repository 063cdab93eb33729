"""Multi-pod dry run of the port (the reference's ``launch/dryrun.py``).

For every (architecture x input shape) cell, run the real step function
once against the production meshes

    single-pod: (16, 16)    = 256 devices   ("data", "model")
    multi-pod : (2, 16, 16) = 512 devices   ("pod", "data", "model")

of ``meta`` devices: tensors have shapes and no storage, so nothing is
allocated and no card is needed. The step runs under
``analysis.op_costs.CostCounter``, which records every ATen op and kernel
launch; the record has the reference's keys, with ``run_s`` for its
``lower_s`` and ``compile_s``, ``hbm_fit_80g`` (one H100) for its
``hbm_fit_16g``, and ``memory``: the arguments' bytes per device under the
reference's rules, the step's new outputs, and the peak of live bytes
during the step (``temp_bytes``). The roofline is an H100's
(``analysis.roofline``). A shape or sharding error here is a bug in the
port, as it is in the reference.

``--device cuda`` runs the same cells on one card instead, on a 1 x 1 mesh
of ``cuda:0``, with weights and inputs made from ``--seed``: first the
meta run on a 1 x 1 meta mesh (its bytes decide whether the cell fits
under 90% of the card's memory; the rest are skipped with those bytes,
and a cell whose arguments alone exceed it without its meta run),
then the card run under the same counter, whose FLOPs and bytes must
equal the meta run's, then the step timed (median of 3 after one
warm-up) beside the roofline, and ``torch.cuda.max_memory_allocated``
beside the meta peak.

Records. Every record names its package (``"package": "repro_torch"``)
and goes to ``{out}/{arch}__{shape}__{mesh}[__cuda]__torch.json``, by
default under ``benchmarks/results/dryrun_torch``: a name the reference's
dry run (``{arch}__{shape}__{mesh}.json``) never writes, so neither
package reads or overwrites the other's records, whatever ``--out`` they
share. Without ``--force`` a meta cell whose record exists is returned as
it is, but only if that record names this package; any other file there
is run again and replaced.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k \\
        --mesh single multi
    python -m repro_torch.launch.dryrun --all --include-ann --out DIR
    python -m repro_torch.launch.dryrun --all --include-ann --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import traceback

import torch

from repro_torch.analysis.op_costs import CostCounter, tensor_bytes
from repro_torch.analysis.roofline import analyze, hbm_fit
from repro_torch.configs import get_arch, iter_cells
from repro_torch.distributed.sharding import RowSharded
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.specs import build_cell

FIT_SHARE = 0.9            # of the card's memory a card run may take
TIMED_RUNS = 3
COUNT_RTOL = 1e-9          # card counts against meta: the same program
PEAK_SLACK = 0.1           # the meta peak may fall this far under the card's
PACKAGE = "repro_torch"     # every record's "package"
DEFAULT_OUT = "benchmarks/results/dryrun_torch"
# a card cell runs 4 steps (one counted warm-up, 3 timed): one whose
# roofline alone is over this is skipped (qwen2-1.5b's train_4k fits one
# card at 64 microbatches, at a roofline of ~100 s and ~190 s a step)
CARD_MAX_ROOFLINE_S = 5.0


def _out_tensors(out, args) -> list:
    """The step's results that are not (views of) its arguments."""
    seen = {t.untyped_storage()._cdata for t in _leaves(args)}
    return [t for t in _leaves(out)
            if t.untyped_storage()._cdata not in seen]


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if isinstance(tree, RowSharded):
        return [t for c in tree.copies for t in c.values()]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _leaves(getattr(tree, f))]
    return []


def count_cell(cell) -> dict:
    """Run ``cell`` once under a counter -> the counter, outputs, seconds."""
    counter = CostCounter(outside_split=cell.outside_split)
    for t, n in cell.row_split:
        counter.place(t, n)
    t0 = time.perf_counter()
    with counter:
        out = cell.fn(*cell.args)
    return {"counter": counter, "out": out,
            "run_s": time.perf_counter() - t0}


def cell_record(cell, mesh, mesh_name: str, run: dict) -> dict:
    """The reference's record keys for one counted run."""
    c = run["counter"]
    dev = c.per_device()
    out_bytes = int(sum(tensor_bytes(t) for t in
                        _out_tensors(run["out"], cell.args))
                    / cell.outside_split)
    rep = analyze(dev, arch=cell.arch, shape=cell.shape, mesh_desc=mesh_name,
                  n_devices=mesh.size, model_flops=cell.model_flops,
                  notes=cell.notes, arg_bytes=int(cell.arg_bytes),
                  temp_bytes=int(c.peak_bytes), out_bytes=out_bytes)
    return {
        "package": PACKAGE, "status": "ok", "kind": cell.kind,
        "run_s": round(run["run_s"], 2),
        "hbm_fit_80g": hbm_fit(rep),
        "partition": cell.partition,
        "flops_by_dtype": dict(dev.flops),
        "kernel_launches": {k: v for k, v in dev.op_counts.items()
                            if k in _KERNELS},
        "top_ops_flops": dev.top_ops(8, "flops"),
        "top_ops_bytes": dev.top_ops(8, "bytes"),
        "memory": {"argument_bytes": int(cell.arg_bytes),
                   "output_bytes": out_bytes,
                   "temp_bytes": int(c.peak_bytes),
                   "alias_bytes": 0},
        **rep.to_dict(),
    }


_KERNELS = ("beam_hops", "gather_dist", "l2topk", "embedding_bag",
            "embedding_bag_backward", "bag_grouping")


def record_path(out_dir, arch, shape, mesh_name, device="meta") -> str:
    """Where the port writes a cell's record (the module docstring)."""
    tag = "" if device == "meta" else f"__{device}"
    return os.path.join(out_dir,
                        f"{arch}__{shape}__{mesh_name}{tag}__torch.json")


def _own_record(path: str):
    """The record at ``path`` if it is one this package wrote, else
    None."""
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) and \
        rec.get("package") == PACKAGE else None


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False) -> dict:
    """One cell on a production mesh of meta devices."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    out_path = record_path(out_dir, arch, shape, mesh_name)
    if not force:
        rec = _own_record(out_path)
        if rec is not None:
            return rec
    reason = get_arch(arch).skip_reason(shape)
    if reason:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "skipped", "reason": reason}
    else:
        n = 512 if multi_pod else 256
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    devices=[torch.device("meta")] * n)
        try:
            cell = build_cell(arch, shape, mesh, device="meta")
            rec = cell_record(cell, mesh, mesh_name, count_cell(cell))
        except Exception as e:                      # noqa: BLE001
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
    _write(out_path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    """Write ``rec`` (which gains its ``"package"``) to ``path``."""
    rec["package"] = PACKAGE
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def _sync():
    torch.cuda.synchronize()


def run_cell_cuda(arch: str, shape: str, out_dir: str, seed: int = 0
                  ) -> dict:
    """One cell on one card (1 x 1 mesh of ``cuda:0``), after its meta run
    on a 1 x 1 meta mesh: skipped unless that run's argument bytes plus
    its peak fit under ``FIT_SHARE`` of the card's memory less what the
    process already holds (a cell whose arguments alone do not fit is
    skipped before its meta run, and one whose roofline is over
    ``CARD_MAX_ROOFLINE_S`` after it); else counted, timed and its peak
    read.
    The record holds both runs' counts (the caller compares them)."""
    from repro_torch.kernels.beam_hop import beam_hops_cuda
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        bag_grouping_cuda, embedding_bag_backward_cuda, embedding_bag_cuda
    from repro_torch.kernels.gather_dist import gather_dist_cuda
    from repro_torch.kernels.l2topk import l2topk_cuda
    wrappers = {"beam_hops": beam_hops_cuda, "gather_dist": gather_dist_cuda,
                "l2topk": l2topk_cuda, "embedding_bag": embedding_bag_cuda,
                "embedding_bag_backward": embedding_bag_backward_cuda,
                "bag_grouping": bag_grouping_cuda}
    base = {"arch": arch, "shape": shape, "mesh": "1x1", "device": "cuda"}
    reason = get_arch(arch).skip_reason(shape)
    if reason:
        rec = {**base, "status": "skipped", "reason": reason}
        _write(record_path(out_dir, arch, shape, "1x1", "cuda"), rec)
        return rec
    meta_mesh = make_mesh((1, 1), ("data", "model"), [torch.device("meta")])
    meta_cell = build_cell(arch, shape, meta_mesh, device="meta", seed=seed)
    cap = FIT_SHARE * torch.cuda.get_device_properties(0).total_memory \
        - torch.cuda.memory_allocated()
    if meta_cell.arg_bytes > cap:            # no need to run it to know
        rec = {**base, "status": "skipped",
               "reason": f"arguments alone {meta_cell.arg_bytes / 1e9:.2f} "
                         f"GB of {cap / 1e9:.2f}"}
        _write(record_path(out_dir, arch, shape, "1x1", "cuda"), rec)
        return rec
    meta = cell_record(meta_cell, meta_mesh, "1x1", count_cell(meta_cell))
    del meta_cell
    need = meta["memory"]["argument_bytes"] + meta["memory"]["temp_bytes"]
    roof_s = max(meta["compute_s"], meta["memory_s"], meta["collective_s"])
    if roof_s > CARD_MAX_ROOFLINE_S:
        rec = {**base, "status": "skipped", "meta": meta,
               "reason": f"roofline {roof_s:.1f} s a step, over the "
                         f"{CARD_MAX_ROOFLINE_S:.0f} s a card cell may take"}
        _write(record_path(out_dir, arch, shape, "1x1", "cuda"), rec)
        return rec
    if need > cap:
        rec = {**base, "status": "skipped", "meta": meta,
               "reason": f"needs {need / 1e9:.2f} GB (arguments "
                         f"{meta['memory']['argument_bytes'] / 1e9:.2f} + "
                         f"peak {meta['memory']['temp_bytes'] / 1e9:.2f}) "
                         f"of {cap / 1e9:.2f}"}
        _write(record_path(out_dir, arch, shape, "1x1", "cuda"), rec)
        return rec
    mesh = make_mesh((1, 1), ("data", "model"), [torch.device("cuda", 0)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cell = build_cell(arch, shape, mesh, device="cuda", seed=seed)
    _sync()
    args_on_card = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    launches0 = {k: w.launches for k, w in wrappers.items()}
    run = count_cell(cell)
    _sync()
    launches = {k: w.launches - launches0[k] for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() - before
    card = cell_record(cell, mesh, "1x1", run)
    del run
    times = []
    for _ in range(TIMED_RUNS):
        _sync()
        t0 = time.perf_counter()
        cell.fn(*cell.args)
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    roof_ms = max(card["compute_s"], card["memory_s"],
                  card["collective_s"]) * 1e3
    meta_peak = meta["memory"]["argument_bytes"] + \
        meta["memory"]["temp_bytes"]
    same = all(abs(card[k] - meta[k]) <= COUNT_RTOL * max(abs(meta[k]), 1.0)
               for k in ("flops_per_device", "bytes_per_device"))
    rec = {**base, "status": "ok", "kind": card["kind"],
           "counts_equal": same,
           "peak_covered": meta_peak >= (1 - PEAK_SLACK) * peak,
           "ms": ms, "ms_runs": times, "roofline_ms": roof_ms,
           "share": roof_ms / ms if ms else 0.0,
           "bottleneck": card["bottleneck"],
           "flops": card["flops_per_device"],
           "bytes": card["bytes_per_device"],
           "meta_flops": meta["flops_per_device"],
           "meta_bytes": meta["bytes_per_device"],
           "peak_bytes": peak, "args_on_card": args_on_card,
           "meta_peak_bytes": meta_peak,
           "launches": launches,
           "counted_kernels": card["kernel_launches"],
           "meta_kernels": meta["kernel_launches"],
           "card": card, "meta": meta}
    del cell
    torch.cuda.empty_cache()
    _write(record_path(out_dir, arch, shape, "1x1", "cuda"), rec)
    return rec


def select_cells(args) -> list:
    cells = []
    for arch, shape, _ in iter_cells(include_ann=args.include_ann or
                                     args.arch == "ann-laion"):
        if args.arch and arch != args.arch:
            continue
        if args.shape and shape != args.shape:
            continue
        cells.append((arch, shape))
    if not cells:
        raise SystemExit("no cells selected")
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", nargs="+", default=["single", "multi"],
                    choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-ann", action="store_true",
                    help="also run the paper's own ANN workload cells")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="enable all beyond-baseline optimizations (flags.py)")
    ap.add_argument("--device", default="meta", choices=["meta", "cuda"],
                    help="meta: the production meshes, nothing allocated; "
                         "cuda: each cell on one card, 1 x 1 mesh")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and inputs of the --device cuda runs")
    ap.add_argument("--jobs", type=int, default=1,
                    help="meta: run the cells in this many worker "
                         "processes")
    args = ap.parse_args(argv)
    if args.opt:
        from repro_torch import flags
        flags.enable_all()
    torch.set_num_threads(1)
    cells = select_cells(args)
    if args.device == "cuda":
        return _main_cuda(cells, args)

    n_ok = n_skip = n_err = 0
    t0 = time.perf_counter()
    jobs = [(arch, shape, mesh == "multi", args.out, args.force)
            for arch, shape in cells for mesh in args.mesh]
    for rec in _records(jobs, args.jobs):
        status = rec["status"]
        if status == "ok":
            n_ok += 1
            print(f"[OK]   {rec['arch']:22s} {rec['shape']:15s} {rec['mesh']:8s} "
                  f"run={rec['run_s']:6.1f}s "
                  f"mem={rec['memory']['argument_bytes']/1e9:6.2f}+"
                  f"{rec['memory']['temp_bytes']/1e9:5.2f}GB "
                  f"bottleneck={rec['bottleneck']}", flush=True)
            print(compiled_summary(rec), flush=True)
        elif status == "skipped":
            n_skip += 1
            print(f"[SKIP] {rec['arch']:22s} {rec['shape']:15s} {rec['mesh']:8s} "
                  f"{rec['reason'][:60]}", flush=True)
        else:
            n_err += 1
            print(f"[ERR]  {rec['arch']:22s} {rec['shape']:15s} {rec['mesh']:8s} "
                  f"{rec['error'][:120]}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err} "
          f"seconds={time.perf_counter() - t0:.1f}")
    raise SystemExit(1 if n_err else 0)


def _run_job(job) -> dict:
    torch.set_num_threads(1)
    return run_cell(*job)


def _records(jobs, n_workers: int):
    """``run_cell`` over ``jobs`` in order, in ``n_workers`` processes."""
    if n_workers <= 1:
        yield from (run_cell(*job) for job in jobs)
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(n_workers,
                             mp_context=mp.get_context("spawn")) as pool:
        yield from pool.map(_run_job, jobs)


def _main_cuda(cells, args):
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a card")
    from repro_torch.core.device import resolve_device
    resolve_device("cuda")          # full-float32 products, as the port
    n_ok = n_skip = n_err = 0
    for arch, shape in cells:
        try:
            rec = run_cell_cuda(arch, shape, args.out, args.seed)
        except Exception as e:                      # noqa: BLE001
            rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            _write(record_path(args.out, arch, shape, "1x1", "cuda"), rec)
        if rec["status"] == "ok":
            n_ok += 1
            print(f"[OK]   {arch:22s} {shape:15s} ms={rec['ms']:9.3f} "
                  f"roofline={rec['roofline_ms']:9.3f} "
                  f"share={rec['share']:.3f} "
                  f"peak={rec['peak_bytes']/1e9:.2f}GB "
                  f"meta_peak={rec['meta_peak_bytes']/1e9:.2f}GB "
                  f"counts_equal={rec['counts_equal']} "
                  f"peak_covered={rec['peak_covered']}", flush=True)
            if not (rec["counts_equal"] and rec["peak_covered"]):
                n_err += 1
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"[SKIP] {arch:22s} {shape:15s} {rec['reason'][:70]}",
                  flush=True)
        else:
            n_err += 1
            print(f"[ERR]  {arch:22s} {shape:15s} {rec['error'][:200]}",
                  flush=True)
            print(rec["trace"], flush=True)
    print(f"done: ok={n_ok} skip={n_skip} err={n_err}")
    raise SystemExit(1 if n_err else 0)


def compiled_summary(rec: dict) -> str:
    return ("       terms: compute={:.2e}s memory={:.2e}s "
            "collective={:.2e}s useful={:.2f}".format(
                rec["compute_s"], rec["memory_s"], rec["collective_s"],
                rec["useful_ratio"]))


if __name__ == "__main__":
    main()
