"""Ask/tell Study with soft constraints and Pareto fronts (paper §3.2).

Two modes, exactly the paper's two strategies:
  * single-objective + constraint:  maximize QPS s.t. Recall@k >= 0.9
  * multi-objective:                maximize (QPS, Recall@k) -> Pareto front

A copy of the reference's ``core/tuning/study.py`` (numpy only).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tuning.samplers import RandomSampler, TPESampler, \
    _nondominated_sort
from repro_torch.core.tuning.space import SearchSpace


@dataclass
class Trial:
    number: int
    params: Dict[str, Any]
    values: Optional[Tuple[float, ...]] = None      # maximized
    constraints: Tuple[float, ...] = ()             # feasible iff all <= 0
    user_attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        return all(c <= 0.0 for c in self.constraints)


class Study:
    def __init__(self, space: SearchSpace, sampler=None, n_objectives: int = 1):
        self.space = space
        self.sampler = sampler or TPESampler()
        self.n_objectives = n_objectives
        self.trials: List[Trial] = []

    # -- ask / tell ---------------------------------------------------------
    def ask(self) -> Trial:
        params = self.sampler.suggest(self.space, self.trials)
        t = Trial(number=len(self.trials), params=params)
        self.trials.append(t)
        return t

    def tell(self, trial: Trial, values,
             constraints: Sequence[float] = ()) -> None:
        values = (values,) if np.isscalar(values) else tuple(values)
        assert len(values) == self.n_objectives
        trial.values = tuple(float(v) for v in values)
        trial.constraints = tuple(float(c) for c in constraints)

    # -- driver --------------------------------------------------------------
    def optimize(self, objective: Callable[[Trial], Any], n_trials: int = 50,
                 timeout: Optional[float] = None) -> "Study":
        """objective(trial) -> value | (values tuple) |
        dict(values=..., constraints=...)."""
        t0 = time.perf_counter()
        for _ in range(n_trials):
            if timeout and time.perf_counter() - t0 > timeout:
                break
            t = self.ask()
            res = objective(t)
            if isinstance(res, dict):
                self.tell(t, res["values"], res.get("constraints", ()))
            else:
                self.tell(t, res)
        return self

    # -- results --------------------------------------------------------------
    def completed(self) -> List[Trial]:
        return [t for t in self.trials if t.values is not None]

    @property
    def best_trial(self) -> Trial:
        done = self.completed()
        if not done:
            raise ValueError("no completed trials")
        assert self.n_objectives == 1
        feas = [t for t in done if t.feasible]
        pool = feas or done
        return max(pool, key=lambda t: t.values[0])

    def pareto_front(self) -> List[Trial]:
        done = [t for t in self.completed() if t.feasible]
        if not done:
            return []
        return _nondominated_sort(done)[0]

    def best_feasible_by(self, key: Callable[[Trial], float]) -> Optional[Trial]:
        feas = [t for t in self.completed() if t.feasible]
        return max(feas, key=key) if feas else None
