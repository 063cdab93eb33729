"""Training launcher (the reference's ``launch/train.py``): ``--arch <id>``
trains one architecture end to end (data stream, loss, optimizer,
checkpoints).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-1.5b|mistral-nemo-12b|qwen3-32b --steps 10 \\
        [--batch 8] [--seq 64] [--full-config] [--ckpt-dir DIR] \\
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch two-tower-retrieval|sasrec|din|dlrm-mlperf --steps 10 \\
        [--batch 8] [--full-config] [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch dimenet \\
        --steps 10 [--full-config] [--ckpt-dir DIR] [--device cpu]

It builds the arch's smoke config (``--full-config``: the full one) from
seed 0, draws batch s from a generator seeded s (the stream is a pure
function of the step, so a resume replays it), trains the LMs on
``--seq``-token sequences with ``adamw(3e-4)``, the recsys models with
``mixed_optimizer(1e-3)`` (row-wise Adagrad for the table, AdamW for the
rest) and DimeNet with ``adamw(1e-3)`` on the reference's padded graph
batch (``make_dimenet_batch(step, 64 nodes, 128 edges, 512 triplets, 4
graphs)``, built on the host and moved to the device), checkpoints every
max(2, steps // 2) steps and prints the reference's line, ``<arch>:
trained <n> steps; history=[...]``: the loss every max(1, steps // 4)
steps. Without ``--ckpt-dir`` the checkpoints go to a temporary directory
removed at exit. The ANN id exits as the reference does (the tuner is its
training). The port runs on the card by default; ``--device cpu`` runs
the plain PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_batch, recsys_batch
from repro_torch.data.graph_sampler import graph_to_device, \
    make_dimenet_batch
from repro_torch.models import dimenet, recsys, transformer
from repro_torch.optim import adamw, mixed_optimizer
from repro_torch.train.train_step import loss_fn_for, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_parts(spec, cfg, batch_size: int, seq: int, dev: torch.device):
    """(init, batch_fn, optimizer) of an LM, GNN or recsys arch on
    ``dev``."""
    def gen(seed: int):
        return torch.Generator(device=dev).manual_seed(seed)

    if spec.family == "lm":
        return (lambda seed: transformer.init_params(gen(seed), cfg),
                lambda step: lm_batch(gen(step), batch_size, seq,
                                      cfg.vocab_size),
                adamw(3e-4))
    if spec.family == "gnn":
        return (lambda seed: dimenet.init_params(gen(seed), cfg),
                lambda step: graph_to_device(make_dimenet_batch(
                    step, n_nodes=64, n_edges=128, n_triplets=512,
                    n_graphs=4), dev),
                adamw(1e-3))
    if spec.family != "recsys":
        raise SystemExit(f"train not defined for family {spec.family}; "
                         "use launch/tune.py for the ANN workload")
    fam = recsys.family_of(cfg)
    return (lambda seed: recsys.INIT[fam](gen(seed), cfg),
            lambda step: recsys_batch(gen(step), batch_size, cfg),
            mixed_optimizer(1e-3))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, help=f"one of {list_archs()}")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens per sequence (lm family only)")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (hardware-scale) config")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at exit)")
    ap.add_argument("--device", default="cuda",
                    help="where the port runs: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    return ap


def train(args) -> Trainer:
    spec = get_arch(args.arch)
    cfg = spec.config if args.full_config else spec.smoke_config
    dev = resolve_device(args.device)
    init, batch_fn, opt = make_parts(spec, cfg, args.batch, args.seq, dev)
    step = make_train_step(loss_fn_for(spec.family, cfg), opt)

    def step_fn(state, batch):
        model, opt_state = state
        model, opt_state, metrics = step(model, opt_state, batch)
        return (model, opt_state), metrics

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(step_fn, batch_fn, TrainerConfig(
            total_steps=args.steps, ckpt_every=max(2, args.steps // 2),
            ckpt_dir=args.ckpt_dir or tmp,
            log_every=max(1, args.steps // 4)))
        model = init(0)
        try:
            trainer.run((model, opt.init(model)))
        finally:
            trainer.ckpt.close()
    return trainer


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    trainer = train(args)
    print(f"{args.arch}: trained {args.steps} steps; "
          f"history={[round(h['loss'], 4) for h in trainer.history]}")


if __name__ == "__main__":
    main()
