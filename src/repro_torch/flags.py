"""Optimization toggles (the reference's ``flags.py``): the three ANN
toggles and the four of the LM.

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

The LM's:

  * ``SHARDED_CE`` (``REPRO_SHARDED_CE``): ``models.transformer.lm_loss``
    takes the cross entropy as ``max + log(sum(exp(logits - max)))`` minus
    the label's logit picked by a one-hot product, instead of
    ``log_softmax`` and a gather. In the tensor-parallel LM (``mesh=``)
    the vocabulary-parallel head's logits then never gather: each shard
    reduces its columns and three (tokens,) all-reduces combine them;
    without a mesh it changes only the arithmetic (the loss agrees to
    float32 rounding).
  * ``HEAD_TP_ATTENTION`` (``REPRO_HEAD_TP``): the reference places
    ``chunked_sdpa``'s q on the mesh's ``model`` axis by heads instead of
    by sequence, and only when a mesh is active. So does the port's
    tensor-parallel LM (``layers.gqa_apply_tp``: head-TP when the heads
    divide ``model``, else sequence-parallel); without a mesh it is
    read by nothing and the numbers are the same.
  * ``GRAD_SHARD_CONSTRAINTS`` (``REPRO_GRAD_SHARD``) and ``LM_FSDP``
    (``REPRO_FSDP``): pin the gradients' and the LM parameters' shardings
    over the data axes. ``launch/specs.py`` reads them for the dry run's
    per-device bytes (``LM_FSDP``: the big parameters and their moments
    also over the data axes); ``GRAD_SHARD_CONSTRAINTS`` only notes a
    cell, as the one-process step has no gradient placement to pin.
    ``enable_all`` / ``disable_all`` flip every toggle (the dry run's
    ``--opt``).

The reference's ``MOE_SHARD_CONSTRAINTS`` (``REPRO_MOE_SHARD``) pins the
MoE dispatch tensors' shardings on a mesh: the dispatch groups over the
data axes, the experts over ``model``. It has no counterpart: the port's
expert-parallel program (``models.moe.moe_apply_tp``) runs that placement
on every mesh (each batch group its own dispatch groups, each ``model``
shard its experts' slots), and without a mesh there is none to pin.
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


# P2: sharded-vocab-safe cross entropy (never gathers (tokens, V) logits)
SHARDED_CE = _env("REPRO_SHARDED_CE", False)

# P5: pin the grad accumulator to the params' sharding
GRAD_SHARD_CONSTRAINTS = _env("REPRO_GRAD_SHARD", False)

# P6: head-TP attention when n_heads divides the model axis
HEAD_TP_ATTENTION = _env("REPRO_HEAD_TP", False)

# P7: FSDP of the big LM params over the data axes
LM_FSDP = _env("REPRO_FSDP", False)

# every toggle above (the reference's ``_ALL`` less MOE_SHARD_CONSTRAINTS)
_ALL = ["SHARDED_CE", "ANN_BF16_BASE", "ANN_TIGHT_BUDGET",
        "GRAD_SHARD_CONSTRAINTS", "HEAD_TP_ATTENTION", "LM_FSDP",
        "ANN_PRENORM"]


def enable_all():
    """Turn every toggle on (the dry run's ``--opt``)."""
    g = globals()
    for name in _ALL:
        g[name] = True


def disable_all():
    g = globals()
    for name in _ALL:
        g[name] = False
