"""Optimization toggles of the ANN serving path (the reference's
``flags.py``, its three ANN toggles; the LM toggles come with the LM
family).

Each toggle reads the reference's environment variable, off by default,
and is read at call time (``flags.ANN_TIGHT_BUDGET``), so a test can flip
it on the module.

  * ``ANN_TIGHT_BUDGET`` (``REPRO_ANN_TIGHT``): the sharded searches'
    beam budget is ``2 * ef`` hops instead of ``4 * ef``; honoured.
  * ``ANN_BF16_BASE`` (``REPRO_ANN_BF16``): bf16 database rows in the
    sharded search, and ``ANN_PRENORM`` (``REPRO_ANN_PRENORM``): the
    ``|q|^2 + |x|^2 - 2 x.q`` distance over norms kept at build time.
    Both change what the hop kernel reads and how it sums; the port's
    ``beam_hops`` has neither mode yet, so the sharded entry points raise
    ``NotImplementedError`` while either is on (``check_ann_toggles``)
    rather than serve them through a path without the kernel.
"""
from __future__ import annotations

import os


def _env(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v not in ("0", "false", "False", "")


# P3: bf16 database vectors in the ANN sharded search
ANN_BF16_BASE = _env("REPRO_ANN_BF16", False)

# P4: beam iteration budget 2*ef instead of 4*ef
ANN_TIGHT_BUDGET = _env("REPRO_ANN_TIGHT", False)

# P8: |x|^2 per database row precomputed at build time
ANN_PRENORM = _env("REPRO_ANN_PRENORM", False)


def check_ann_toggles() -> None:
    """Raise if a toggle the port's hop kernel cannot serve is on."""
    on = [name for name in ("ANN_BF16_BASE", "ANN_PRENORM")
          if globals()[name]]
    if on:
        raise NotImplementedError(
            f"{', '.join(on)}: the beam_hops kernel has no bf16-row or "
            f"prenorm mode yet (ROADMAP Queue 1 item 9b); unset "
            f"REPRO_ANN_BF16 / REPRO_ANN_PRENORM")
