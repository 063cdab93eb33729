"""Carry an index across from the reference package.

``index_from_jax_state`` takes the dict that ``repro``'s
``TunedGraphIndex.state_dict()`` returns — with every array passed through
``np.asarray`` — and returns the port's index over the same arrays, so
both packages can search one graph. This module never imports the
reference: it reads the plain ``{"meta", "arrays"}`` layout.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.pipeline import TunedGraphIndex


def index_from_jax_state(state: dict, device=None) -> TunedGraphIndex:
    """Reference state dict (numpy arrays) -> the port's TunedGraphIndex
    on ``device`` (default: the card). Codec keys raise for now."""
    arrays = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return TunedGraphIndex.from_state(
        {"meta": state["meta"], "arrays": arrays}, device=device)
