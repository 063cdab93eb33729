"""Carry an index or a model across from the reference package.

``index_from_jax_state`` takes what ``repro``'s ``index_state(index)``
returns — or, for its ``TunedGraphIndex``, what ``state_dict()`` returns
(no ``family`` tag) — with every array passed through ``np.asarray``, and
returns the port's index of the same family over the same arrays
(``core.persist.index_from_state``), so both packages search one index.
This module never imports the reference: it reads the plain ``{"family",
"meta", "arrays"}`` layout.

``recsys_params_from_jax`` does the same for the two-tower model: it takes
the reference's params pytree (``{"table", "user_tower": {"layers": [{"w",
"b"}, ...]}, "item_tower"}``) and returns the port's ``TwoTower``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.persist import index_from_state
from repro_torch.models.layers import MLP
from repro_torch.models.recsys import TwoTower


def index_from_jax_state(state: dict, device=None):
    """Reference index state (numpy arrays) -> the port's index of the same
    family on ``device`` (default: the card); a state without a
    ``family`` tag is a ``TunedGraphIndex``'s."""
    arrays = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return index_from_state({"family": state.get("family",
                                                 "TunedGraphIndex"),
                             "meta": state["meta"], "arrays": arrays},
                            device=device)


def recsys_params_from_jax(params: dict, cfg, device=None) -> TwoTower:
    """Reference two-tower params (any array type numpy reads) -> the
    port's ``TwoTower`` on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(np.asarray(a))).to(dev)

    def mlp(p):
        return MLP([t(lyr["w"]) for lyr in p["layers"]],
                   [t(lyr["b"]) for lyr in p["layers"]])

    return TwoTower(cfg, t(params["table"]), mlp(params["user_tower"]),
                    mlp(params["item_tower"]))
