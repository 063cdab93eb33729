"""Optimization toggles of the ANN serving path (the reference's
``flags.py``, its three ANN toggles; the LM toggles come with the LM
family).

Each toggle reads the reference's environment variable, off by default,
and is read at call time (``flags.ANN_TIGHT_BUDGET``), so a test can flip
it on the module.

  * ``ANN_TIGHT_BUDGET`` (``REPRO_ANN_TIGHT``): the sharded searches'
    beam budget is ``2 * ef`` hops instead of ``4 * ef``.
  * ``ANN_BF16_BASE`` (``REPRO_ANN_BF16``): the sharded tiers keep their
    database rows in bf16 (half the bytes on the card and in the host
    store); the hops widen each row to f32 as they read it.
  * ``ANN_PRENORM`` (``REPRO_ANN_PRENORM``): the sharded searches score
    by ``max(|q|^2 + |x|^2 - 2 x.q, 0)`` over the ``|x|^2`` kept at build
    time (of the f32 rows, before any bf16 cast).

All three are honoured by ``core.distributed``'s sharded tiers, alone or
together, as in the reference; the unsharded index has none of them.
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

