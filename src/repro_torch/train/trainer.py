"""Fault-tolerant training loop (the reference's ``train/trainer.py``).

  * checkpoint every ``ckpt_every`` steps, asynchronously and atomically;
    a resume picks the newest complete checkpoint (a crash mid-write
    leaves only a ``.tmp`` directory, which restore ignores);
  * the data order is a pure function of the step, so a resume replays the
    exact stream with no state handshake (skip-ahead = start at step s);
  * straggler hook: each step's wall time is watched, and a step slower
    than ``straggler_factor`` times the median of the last 50 calls
    ``on_straggler(step, slowdown)``.

A step's time ends in a device synchronize when the state lives on the
card, so the watchdog times the work, not its enqueueing.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, tree_leaves


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    min_steps_for_watchdog: int = 5


def _host_metrics(metrics) -> Dict[str, float]:
    """The 0-dim metrics as Python floats (one host read each)."""
    return {k: float(v) for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() == 0}


def _synchronize(state) -> None:
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class Trainer:
    def __init__(self, step_fn: Callable, batch_fn: Callable,
                 cfg: TrainerConfig,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        """step_fn(state, batch) -> (state, metrics);
        batch_fn(step: int) -> batch (pure in step)."""
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.on_straggler = on_straggler or (lambda s, t: None)
        self.step_times: List[float] = []
        self.slow_steps: List[int] = []
        self.history: List[Dict[str, float]] = []

    def restore_or_init(self, init_state):
        if self.ckpt.latest_step() is not None:
            return self.ckpt.restore(init_state)
        return init_state, 0

    def run(self, state, start_step: int = 0):
        cfg = self.cfg
        for step in range(start_step, cfg.total_steps):
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            _synchronize(state)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if len(self.step_times) > cfg.min_steps_for_watchdog:
                med = statistics.median(self.step_times[-50:])
                if dt > cfg.straggler_factor * med:
                    self.slow_steps.append(step)
                    self.on_straggler(step, dt / med)
            if (step + 1) % cfg.ckpt_every == 0 or \
                    step + 1 == cfg.total_steps:
                self.ckpt.save(step + 1, state)
            if (step + 1) % cfg.log_every == 0:
                self.history.append(_host_metrics(metrics))
        self.ckpt.wait()
        return state
