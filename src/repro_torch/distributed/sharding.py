"""Row sharding on a mesh — the ANN part of the reference's
``distributed/sharding.py`` (database rows on the ``model`` axis); the LM,
recsys and GNN rules come with those families.

``RowSharded`` is what the reference's ``NamedSharding(mesh, P("model",
...))`` array is here: a ``(S * m, ...)`` array held as S equal blocks,
block s placed on every device of mesh column s (replicated over the
other axes; a device named twice holds one copy). Nothing concatenates the
blocks except ``to_host`` — the flat read for counts and tests.

``shard_map`` plays the role of the reference's ``shard_map``: it runs a
per-shard body on the device that owns each shard, in one process, and
collects the results — row-sharded (one output block per shard) or
batch-major (the query batch split over the batch axes, each shard's
columns side by side in shard order).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def model_size(mesh) -> int:
    return mesh.shape["model"]


def columns(mesh) -> np.ndarray:
    """The mesh's devices as (groups, shards): row g is one batch group,
    column s the devices that hold shard s."""
    axis = mesh.axis_names.index("model")
    return np.moveaxis(mesh.devices, axis, -1).reshape(-1, model_size(mesh))


class RowSharded:
    """S equal row blocks, block s on the devices of mesh column s."""

    def __init__(self, mesh, blocks: Sequence[torch.Tensor]):
        s = model_size(mesh)
        if len(blocks) != s:
            raise ValueError(f"{len(blocks)} blocks for {s} `model` shards")
        shapes = {tuple(b.shape) for b in blocks}
        if len(shapes) > 1:
            raise ValueError(f"blocks must be equal-shape, got {shapes}")
        cols = columns(mesh)
        self.mesh = mesh
        # copies[s][device] = block s on that device
        self.copies: List[dict] = []
        for i, b in enumerate(blocks):
            per = {}
            for dev in cols[:, i]:
                if dev not in per:
                    per[dev] = b.to(dev)
            self.copies.append(per)

    @property
    def blocks(self) -> List[torch.Tensor]:
        """Each shard's block on the first device of its column."""
        return [next(iter(c.values())) for c in self.copies]

    def local(self, shard: int, device) -> torch.Tensor:
        return self.copies[shard][torch.device(device)]

    @property
    def shape(self) -> tuple:
        b = self.blocks[0]
        return (len(self.copies) * b.shape[0],) + tuple(b.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def nbytes(self) -> int:
        """The logical array's bytes (replicas not counted), as the
        reference's ``jax.Array.nbytes``."""
        b = self.blocks[0]
        return len(self.copies) * b.numel() * b.element_size()

    def to_host(self) -> torch.Tensor:
        """The flat ``(S * m, ...)`` array on the CPU (a host copy)."""
        return torch.cat([b.cpu() for b in self.blocks])

    def __array__(self, dtype=None, copy=None):
        a = self.to_host().numpy()
        return a if dtype is None else a.astype(dtype)


def put_row_sharded(mesh, x: torch.Tensor) -> RowSharded:
    """``x`` with its leading dim split over ``model`` (it must divide)."""
    s = model_size(mesh)
    if x.shape[0] % s:
        raise ValueError(f"{x.shape[0]} rows do not split over {s} shards")
    return RowSharded(mesh, list(x.split(x.shape[0] // s)))


def row_sharded_from_blocks(mesh, blocks) -> RowSharded:
    """Assemble a ``model``-row-sharded array from per-shard blocks, each
    placed straight on its column's devices (no ``(S * m, ...)`` array is
    ever built; trailing dims are never split)."""
    return RowSharded(mesh, list(blocks))


def _arg(a, shard: int, dev):
    return a.local(shard, dev) if isinstance(a, RowSharded) else a


def shard_map(fn: Callable, mesh, *args, batch=None, out: str = "rows"):
    """Run ``fn`` once per shard on the device that owns it.

    ``args`` are ``RowSharded`` (each call gets its shard's block) or
    passed through unchanged. ``out="rows"``: ``fn(*blocks)`` runs once
    per shard on the first device of its column and its result (a tensor)
    becomes block s of a ``RowSharded``. ``out="batch"``: ``batch`` (a
    (Q, ...) tensor) is split into equal parts over the batch groups,
    ``fn(part, *blocks)`` runs on every (group, shard) device and returns
    a tuple of (Q_g, w) tensors; the shards' results sit side by side in
    shard order along axis 1, the groups' along axis 0, on ``batch``'s
    device.
    """
    cols = columns(mesh)
    n_groups, n_shards = cols.shape
    if out == "rows":
        return RowSharded(mesh, [
            fn(*(_arg(a, s, cols[0, s]) for a in args))
            for s in range(n_shards)])
    if out != "batch":
        raise ValueError(f"out must be 'rows' or 'batch', got {out!r}")
    if batch.shape[0] % n_groups:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over "
                         f"{n_groups} batch groups")
    home = batch.device
    groups = []
    for g, part in enumerate(batch.split(batch.shape[0] // n_groups)):
        per_shard = [fn(part.to(cols[g, s]),
                        *(_arg(a, s, cols[g, s]) for a in args))
                     for s in range(n_shards)]
        groups.append([torch.cat([o[j].to(home) for o in per_shard], dim=1)
                       for j in range(len(per_shard[0]))])
    return tuple(torch.cat([g_[j] for g_ in groups])
                 for j in range(len(groups[0])))
