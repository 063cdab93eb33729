"""Black-box samplers: Random, TPE (Bergstra et al., NIPS'11) and
multi-objective TPE (paper §3.2 uses Optuna's TPE for both modes; this is a
from-scratch implementation, so no Optuna is needed). A copy of the
reference's ``core/tuning/samplers.py`` (numpy only): one seed suggests the
same parameter sequence in both packages.

TPE: split completed trials into a "good" set D_l (top gamma by objective,
feasible-first) and "bad" set D_g; fit univariate Parzen estimators l(x),
g(x) per parameter; draw candidates from l and keep the one maximizing
l(x)/g(x) — the expected-improvement-optimal choice under the TPE model.

Constraints are soft (exactly the paper's caveat): infeasible trials are
never placed in the good set, so the model steers toward feasibility but
cannot guarantee it.

Multi-objective: the good set is filled by ascending non-domination rank
(NSGA-II style), which is the MOTPE split; the l/g machinery is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.tuning.space import Categorical, Float, Int, SearchSpace


class RandomSampler:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def suggest(self, space: SearchSpace, trials) -> Dict[str, Any]:
        return space.sample(self.rng)


# ---------------------------------------------------------------------------
# Parzen estimators
# ---------------------------------------------------------------------------


class _NumericParzen:
    """Gaussian mixture over observed internal values with per-component
    bandwidths from neighbor spacing (Bergstra et al.'s adaptive Parzen
    estimator) + a uniform prior component that keeps exploration alive."""

    def __init__(self, values: np.ndarray, lo: float, hi: float):
        self.lo, self.hi = lo, hi
        span = max(hi - lo, 1e-12)
        mus = np.sort(np.asarray(values, float))
        self.mus = mus
        if len(mus) == 0:
            self.sigmas = np.empty(0)
            return
        # bandwidth_i = max(gap to left/right neighbor), bounds as sentinels
        ext = np.concatenate([[lo], mus, [hi]])
        left = ext[1:-1] - ext[:-2]
        right = ext[2:] - ext[1:-1]
        sig = np.maximum(left, right)
        # "magic clip" (Bergstra): with few observations keep bandwidths wide
        # so a small good-set explores; tighten as evidence accumulates.
        self.sigmas = np.clip(sig, span / min(100.0, 1.0 + len(mus)), span)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty(n)
        for i in range(n):
            if len(self.mus) == 0 or rng.uniform() < 1.0 / (len(self.mus) + 1):
                out[i] = rng.uniform(self.lo, self.hi)      # prior component
            else:
                j = int(rng.integers(len(self.mus)))
                out[i] = np.clip(rng.normal(self.mus[j], self.sigmas[j]),
                                 self.lo, self.hi)
        return out

    def logpdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, float)
        span = max(self.hi - self.lo, 1e-12)
        prior = np.full(x.shape, -math.log(span))
        if len(self.mus) == 0:
            return prior
        z = (x[:, None] - self.mus[None, :]) / self.sigmas[None, :]
        comp = (-0.5 * z ** 2
                - np.log(self.sigmas[None, :] * math.sqrt(2 * math.pi)))
        all_comp = np.concatenate([comp, prior[:, None]], axis=1)
        m = all_comp.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(np.exp(all_comp - m).mean(axis=1)))


class _CategoricalParzen:
    def __init__(self, values: Sequence[Any], choices: Sequence[Any]):
        self.choices = list(choices)
        counts = np.ones(len(self.choices))                 # +1 smoothing
        for v in values:
            counts[self.choices.index(v)] += 1
        self.p = counts / counts.sum()

    def sample(self, rng: np.random.Generator, n: int) -> List[Any]:
        idx = rng.choice(len(self.choices), size=n, p=self.p)
        return [self.choices[i] for i in idx]

    def logpdf_of(self, values: Sequence[Any]) -> np.ndarray:
        return np.array([math.log(self.p[self.choices.index(v)])
                         for v in values])


# ---------------------------------------------------------------------------
# TPE
# ---------------------------------------------------------------------------


class TPESampler:
    def __init__(self, seed: int = 0, n_startup: int = 10,
                 n_candidates: int = 24, gamma=None):
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        # Optuna-style default: 10% of trials, capped at 25
        self.gamma = gamma or (lambda n: min(int(np.ceil(0.1 * n)), 25))
        if not callable(self.gamma):
            g = float(gamma)
            self.gamma = lambda n: max(1, int(np.ceil(g * n)))

    # -- split ------------------------------------------------------------
    def _split(self, trials) -> tuple:
        """Return (good, bad) trial lists."""
        n_good = max(1, self.gamma(len(trials)))
        feas = [t for t in trials if t.feasible]
        infeas = [t for t in trials if not t.feasible]
        if len(trials[0].values) == 1:
            feas.sort(key=lambda t: -t.values[0])            # maximize
            infeas.sort(key=lambda t: sum(max(c, 0.0)
                                          for c in t.constraints))
            ordered = feas + infeas
            good = ordered[:n_good]
            bad = ordered[n_good:]
        else:
            good, bad = self._mo_split(feas, infeas, n_good)
        return good, bad

    def _mo_split(self, feas, infeas, n_good):
        fronts = _nondominated_sort(feas)
        good: list = []
        for front in fronts:
            if len(good) + len(front) <= n_good:
                good.extend(front)
            else:
                good.extend(front[: n_good - len(good)])
            if len(good) >= n_good:
                break
        good_set = set(id(t) for t in good)
        bad = [t for t in feas if id(t) not in good_set] + infeas
        return good, bad

    # -- suggest ----------------------------------------------------------
    def suggest(self, space: SearchSpace, trials) -> Dict[str, Any]:
        done = [t for t in trials if t.values is not None]
        if len(done) < self.n_startup:
            return space.sample(self.rng)
        good, bad = self._split(done)
        out: Dict[str, Any] = {}
        for name, spec in space.params.items():
            gv = [t.params[name] for t in good if name in t.params]
            bv = [t.params[name] for t in bad if name in t.params]
            if isinstance(spec, Categorical):
                lk = _CategoricalParzen(gv, spec.choices)
                gk = _CategoricalParzen(bv, spec.choices)
                cands = lk.sample(self.rng, self.n_candidates)
                score = lk.logpdf_of(cands) - gk.logpdf_of(cands)
                out[name] = cands[int(np.argmax(score))]
            else:
                lo, hi = spec.internal_bounds
                lk = _NumericParzen(np.array([spec.to_internal(v)
                                              for v in gv]), lo, hi)
                gk = _NumericParzen(np.array([spec.to_internal(v)
                                              for v in bv]), lo, hi)
                cands = lk.sample(self.rng, self.n_candidates)
                score = lk.logpdf(cands) - gk.logpdf(cands)
                out[name] = spec.from_internal(float(cands[int(
                    np.argmax(score))]))
        return out


def _dominates(a, b) -> bool:
    """a dominates b (maximize all objectives)."""
    av, bv = a.values, b.values
    return all(x >= y for x, y in zip(av, bv)) and any(
        x > y for x, y in zip(av, bv))


def _nondominated_sort(trials) -> List[list]:
    remaining = list(trials)
    fronts: List[list] = []
    while remaining:
        front = [t for t in remaining
                 if not any(_dominates(o, t) for o in remaining if o is not t)]
        if not front:                                 # duplicates edge case
            front = remaining[:]
        fronts.append(front)
        front_ids = set(id(t) for t in front)
        remaining = [t for t in remaining if id(t) not in front_ids]
    return fronts
