"""Search-space definition for the black-box tuner.

Numeric params carry an internal unconstrained representation (log-space for
log params) so the Parzen estimators in the TPE sampler see roughly
homogeneous scales. A copy of the reference's ``core/tuning/space.py``
(numpy only).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Union

import numpy as np


@dataclass(frozen=True)
class Float:
    low: float
    high: float
    log: bool = False

    def sample(self, rng: np.random.Generator) -> float:
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.low),
                                            np.log(self.high))))
        return float(rng.uniform(self.low, self.high))

    def to_internal(self, v: float) -> float:
        return float(np.log(v)) if self.log else float(v)

    def from_internal(self, u: float) -> float:
        v = float(np.exp(u)) if self.log else float(u)
        return float(np.clip(v, self.low, self.high))

    @property
    def internal_bounds(self):
        if self.log:
            return np.log(self.low), np.log(self.high)
        return self.low, self.high


@dataclass(frozen=True)
class Int:
    low: int
    high: int          # inclusive
    log: bool = False

    def sample(self, rng: np.random.Generator) -> int:
        if self.log:
            return int(round(np.exp(rng.uniform(np.log(self.low),
                                                np.log(self.high)))))
        return int(rng.integers(self.low, self.high + 1))

    def to_internal(self, v: int) -> float:
        return float(np.log(v)) if self.log else float(v)

    def from_internal(self, u: float) -> int:
        v = np.exp(u) if self.log else u
        return int(np.clip(round(v), self.low, self.high))

    @property
    def internal_bounds(self):
        if self.log:
            return np.log(self.low), np.log(self.high)
        return float(self.low), float(self.high)


@dataclass(frozen=True)
class Categorical:
    choices: tuple

    def sample(self, rng: np.random.Generator) -> Any:
        return self.choices[int(rng.integers(len(self.choices)))]


ParamSpec = Union[Float, Int, Categorical]


@dataclass
class SearchSpace:
    params: Dict[str, ParamSpec] = field(default_factory=dict)

    def add(self, name: str, spec: ParamSpec) -> "SearchSpace":
        self.params[name] = spec
        return self

    def sample(self, rng: np.random.Generator) -> Dict[str, Any]:
        return {k: p.sample(rng) for k, p in self.params.items()}

    def names(self) -> List[str]:
        return list(self.params)
