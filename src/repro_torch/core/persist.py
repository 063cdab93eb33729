"""Index snapshot/restore: ``save_index`` / ``load_index`` (the reference's
``core/persist.py``).

Every family implements ``state_dict()`` / ``from_state(state, device)``:
``state_dict()`` returns ``{"meta": <JSON-safe dict>, "arrays": <flat dict
of numpy arrays, each in the reference's dtype>}`` — the complete serving
state — and ``from_state`` rebuilds an index whose ``search`` is
bit-identical to the one saved (the arrays ARE the search inputs; nothing
is refit, re-clustered or re-encoded on load). Since the layout and the
dtypes are the reference's, either package loads the other's snapshot.

On disk a snapshot is one payload directory
(``checkpoint.checkpointer.write_payload``: ``manifest.json`` +
``arrays.npz``, a crc32 per array, committed by an atomic rename).
``load_index`` verifies every checksum, rebuilds the family on ``device``
(default: the card) and runs ``core.validate.validate_index`` before it
hands the index back: byte corruption surfaces as
``IndexIntegrityError("checksum")``, semantic corruption as the violated
invariant's name.

``save_index(..., step=n)`` writes ``step_<n>`` sub-snapshots in one
directory; ``load_index`` on such a directory walks the committed steps
newest-first and falls back past any snapshot that fails verification.
``PreprocessedIndex`` nests its inner index's arrays under ``inner/``
keys, ``ShardedFactoryIndex`` each shard's under ``sub<i>/`` — one flat
npz per snapshot whatever the nesting depth.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (
    ChecksumError, read_payload, write_payload,
)
from repro_torch.core.validate import IndexIntegrityError, validate_index

_FORMAT = 1


def _family_classes() -> Dict[str, type]:
    # late imports: persist sits below the family modules, which import
    # index_api (and would cycle at module scope)
    from repro_torch.core.distributed import ShardedFactoryIndex
    from repro_torch.core.flat import FlatIndex
    from repro_torch.core.hnsw import HNSWIndex
    from repro_torch.core.index_api import PreprocessedIndex
    from repro_torch.core.ivf import IVFIndex
    from repro_torch.core.ivfpq import IVFPQIndex
    from repro_torch.core.pipeline import TunedGraphIndex
    from repro_torch.core.pq import PQIndex
    return {c.__name__: c for c in (
        FlatIndex, IVFIndex, IVFPQIndex, PQIndex, HNSWIndex,
        TunedGraphIndex, PreprocessedIndex, ShardedFactoryIndex)}


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def index_state(index) -> Dict[str, Any]:
    """``state_dict()`` plus the family tag ``from_state`` dispatches on;
    every array on the host as numpy."""
    sd = index.state_dict()
    return {"family": type(index).__name__,
            "meta": sd.get("meta", {}),
            "arrays": {k: _host(v) for k, v in sd.get("arrays", {}).items()}}


def index_from_state(state: Dict[str, Any], device=None):
    """Rebuild an index from ``index_state`` output (any family) on
    ``device`` (default: the card)."""
    fam = state["family"]
    classes = _family_classes()
    if fam not in classes:
        # a subclass registered via register_index (e.g. a third-party
        # family) round-trips through its nearest known ancestor
        for cls in classes.values():
            if any(c.__name__ == fam for c in cls.__subclasses__()):
                return next(c for c in cls.__subclasses__()
                            if c.__name__ == fam).from_state(
                                state, device=device)
        raise IndexIntegrityError(
            "family", f"snapshot names unknown index family {fam!r}")
    return classes[fam].from_state(state, device=device)


def save_index(index, path: str, *, step: Optional[int] = None) -> str:
    """Snapshot ``index`` under ``path``; returns the committed payload dir.

    ``step=None`` writes ``path`` itself as the payload (one snapshot,
    atomically replaced on re-save). ``step=n`` writes ``path/step_<n>``,
    accumulating a history ``load_index`` can fall back through.
    """
    state = index_state(index)
    final = path if step is None else os.path.join(path, f"step_{step:08d}")
    parent = os.path.dirname(final)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return write_payload(final, state["arrays"], meta={
        "format": _FORMAT,
        "family": state["family"],
        "spec": getattr(index, "spec", None),
        "index_meta": state["meta"],
    })


def _load_one(payload_dir: str, *, validate: bool, verify: bool, device):
    try:
        arrays, manifest = read_payload(payload_dir, verify=verify)
    except ChecksumError as e:
        raise IndexIntegrityError("checksum", str(e)) from e
    meta = manifest.get("meta", {})
    if "family" not in meta:
        raise IndexIntegrityError(
            "manifest", f"{payload_dir!r} is not an index snapshot "
            "(no family in manifest meta)")
    index = index_from_state({"family": meta["family"],
                              "meta": meta.get("index_meta", {}),
                              "arrays": arrays}, device=device)
    if meta.get("spec"):
        index.spec = meta["spec"]
    if validate:
        validate_index(index)
    return index


def load_index(path: str, *, validate: bool = True, verify: bool = True,
               device=None):
    """Load a snapshot onto ``device`` (default: the card); raises
    ``IndexIntegrityError`` if it cannot be trusted (checksum mismatch,
    unknown family, violated invariant).

    On a stepped directory (``save_index(..., step=n)`` history) the
    committed steps are tried newest-first: a snapshot that fails
    verification is skipped with a warning and the next-newest valid one
    loads. A single-payload path raises instead of falling back.
    """
    if os.path.exists(os.path.join(path, "manifest.json")):
        return _load_one(path, validate=validate, verify=verify,
                         device=device)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no index snapshot at {path!r}")
    steps = sorted(n for n in os.listdir(path)
                   if n.startswith("step_") and not n.endswith(".tmp")
                   and n[len("step_"):].isdigit())
    if not steps:
        raise FileNotFoundError(f"no index snapshot under {path!r}")
    last_err: Optional[Exception] = None
    for name in reversed(steps):
        sub = os.path.join(path, name)
        try:
            return _load_one(sub, validate=validate, verify=verify,
                             device=device)
        except (IndexIntegrityError, OSError, KeyError, ValueError) as e:
            warnings.warn(f"skipping corrupt index snapshot {sub}: {e}",
                          RuntimeWarning, stacklevel=2)
            last_err = e
    raise IndexIntegrityError(
        "checksum", f"no valid index snapshot under {path!r} "
        f"(newest failure: {last_err})")
