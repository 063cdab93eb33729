"""Where DimeNet's float32 gradients on the card part from a float64 run.

Runs on one CUDA card: ``python3 benchmarks/torch_gnn_precision.py``.
For full_graph_sm at seed 0 and molecule at seed 1 (the published config,
the batches and weights of ``chip_smoke.py``'s gnn phase), it prints one
JSON line per cell: each device's error to a float64 run on the card (of
each leaf's largest magnitude) for the geometry (the radial and spherical
bases) and the gradients, then the gradients with the bases swapped
between the devices (the card's network on the CPU's bases, and the
CPU's network on the card's), and the leaves where the card lies furthest
beyond the CPU. Then each device's gradients against a float64 run on
that device's own ReLU masks (``chip_smoke.gnn_float64_grads``), with the
card's run again with its products (``@``) or its SiLUs computed in
float64 and rounded to float32. Besides, one f32 GEMM on each device
against float64.
"""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = (("full_graph_sm", 0), ("molecule", 1))
DEVICE = "cuda"


def rel(x, y) -> float:
    """max |x - y| over max |y|, on the CPU in float64."""
    x, y = x.detach().cpu().double(), y.detach().cpu().double()
    return float((x - y).abs().max()) / (float(y.abs().max()) or 1.0)


def main() -> int:
    import torch
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("torch_gnn_precision: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    import chip_smoke as C
    from repro_torch.configs import get_arch
    from repro_torch.data.graph_sampler import graph_to_device
    from repro_torch.models import dimenet

    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "precision": torch.get_float32_matmul_precision()}))
    g = torch.Generator().manual_seed(0)
    a = torch.randn((8192, 1024), generator=g)
    b = torch.randn((1024, 128), generator=g)
    want = a.double() @ b.double()
    print(json.dumps({"gemm_8192x1024x128": {
        "cpu": rel(a @ b, want),
        "card": rel(a.to(DEVICE) @ b.to(DEVICE), want)}}))

    cfg = get_arch("dimenet").config
    kept = dimenet.radial_basis, dimenet.spherical_basis
    for cell, seed in CASES:
        host = C.gnn_batch(cell, seed)
        d_feat = host["x"].shape[1] if "x" in host else 0
        model = dimenet.init_params(torch.Generator().manual_seed(seed), cfg,
                                    d_feat)
        card_graph = graph_to_device(host, DEVICE)
        cpu_graph = graph_to_device(host, "cpu")
        card_model = copy.deepcopy(model).to(DEVICE)

        def run(m, graph, bases=None, wide=False):
            """gnn_loss_and_grads, recording the bases, or replacing them
            with ``bases`` (moved to the run's device)."""
            seen = {}

            def rb(d, c):
                out = kept[0](d, c) if bases is None else \
                    bases["rbf"].to(d.device, d.dtype)
                seen["rbf"] = out.detach()
                return out

            def sb(d, ang, c):
                out = kept[1](d, ang, c) if bases is None else \
                    bases["sbf"].to(d.device, d.dtype)
                seen["sbf"] = out.detach()
                return out
            dimenet.radial_basis, dimenet.spherical_basis = rb, sb
            try:
                grads = (C.gnn_float64_grads if wide else
                         C.gnn_loss_and_grads)(torch, m, cfg, graph)
            finally:
                dimenet.radial_basis, dimenet.spherical_basis = kept
            return grads, seen

        wide, wide_bases = run(card_model, card_graph, wide=True)
        card, card_bases = run(card_model, card_graph)
        cpu, cpu_bases = run(model, cpu_graph)
        card_on_cpu_bases, _ = run(card_model, card_graph, cpu_bases)
        cpu_on_card_bases, _ = run(model, cpu_graph, card_bases)
        names = ["loss"] + [n for n, _ in model.named_parameters()]

        def errs(xs):
            return {n: rel(x, y) for n, x, y in zip(names, xs, wide)}
        e_card, e_cpu = errs(card), errs(cpu)
        e_mix_card, e_mix_cpu = errs(card_on_cpu_bases), \
            errs(cpu_on_card_bases)
        top = sorted(names[1:], key=lambda n: -e_card[n]
                     / max(e_cpu[n], 1e-9))[:6]
        print(json.dumps({"cell": cell, "seed": seed, "bases": {
            k: {"card": rel(card_bases[k], wide_bases[k]),
                "cpu": rel(cpu_bases[k], wide_bases[k]),
                "card_vs_cpu": rel(card_bases[k], cpu_bases[k])}
            for k in ("rbf", "sbf")},
            "worst": {k: max(e[n] for n in names[1:]) for k, e in (
                ("card", e_card), ("cpu", e_cpu),
                ("card_on_cpu_bases", e_mix_card),
                ("cpu_on_card_bases", e_mix_cpu))},
            "leaves": {n: {"card": e_card[n], "cpu": e_cpu[n],
                           "card_on_cpu_bases": e_mix_card[n],
                           "cpu_on_card_bases": e_mix_cpu[n]}
                       for n in top}}), flush=True)

        def on_branches(m, graph, swap=()):
            """A float32 run with ``swap``'s ops in float64, against the
            float64 run on its ReLU masks: {leaf: error}."""
            taken = {}
            kept_ops = torch.Tensor.__matmul__, torch.nn.functional.silu
            if "matmul" in swap:
                torch.Tensor.__matmul__ = lambda a, b: torch.matmul(
                    a.double(), b.double()).to(a.dtype)
            if "silu" in swap:
                torch.nn.functional.silu = lambda x, inplace=False: \
                    kept_ops[1](x.double()).to(x.dtype)
            try:
                got = C.gnn_loss_and_grads(torch, m, cfg, graph, taken)
            finally:
                torch.Tensor.__matmul__, torch.nn.functional.silu = kept_ops
            ref = C.gnn_float64_grads(torch, card_model, cfg, card_graph,
                                      {"relu": taken["relu"]})
            return {n: rel(x, y) for n, x, y in zip(names, got, ref)}
        runs = {"cpu": on_branches(model, cpu_graph),
                "card": on_branches(card_model, card_graph)}
        for swap in (("matmul",), ("silu",), ("matmul", "silu")):
            runs["card_f64_" + "_".join(swap)] = on_branches(
                card_model, card_graph, swap)
        worst = max(names[1:], key=lambda n: runs["card"][n])
        print(json.dumps({"cell": cell, "seed": seed, "on_own_masks": {
            k: {"worst": max(e[n] for n in names[1:]),
                "median": sorted(e[n] for n in names[1:])[len(names) // 2],
                worst: e[worst]} for k, e in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
