"""Serving launcher: one batched request cycle per family (the reference's
``launch/serve.py``, recsys branch).

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch two-tower-retrieval [--batch 8] [--device cpu]

It builds the arch's smoke config from seed 0, scores one batch and
retrieves the top 5 of 512 candidates for one user, and prints the
reference's line. The port runs on the card by default; ``--device cpu``
runs the plain PyTorch versions of the kernels instead. The ANN family is
served from a factory spec string in the reference, which is not ported
yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.device import resolve_device
from repro_torch.data import recsys_batch
from repro_torch.models import recsys
from repro_torch.serve.serve_step import recsys_retrieval_step, \
    recsys_score_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {list_archs()}")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the port runs: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family == "ann":
        raise NotImplementedError(
            "--arch ann-laion: the ANN family is served from a factory spec "
            "(PCA32,NSG16,EP16), not ported yet (ROADMAP Queue 1 item 7)")
    dev = resolve_device(args.device)
    cfg = spec.smoke_config

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
