"""Device meshes (the reference's ``launch/mesh.py``).

A ``Mesh`` is an array of ``torch.device``s shaped by named axes —
``("data", "model")`` or ``("pod", "data", "model")`` — driven by one
process: the sharded index runs each shard's work on the device of its
``model`` column and merges on the host side of that loop, as the
reference's single-controller ``shard_map`` does. An explicit device list
may name one device more than once (``[torch.device("cpu")] * 8`` in the
CPU tests, ``[cuda:0] * 4`` for four shards on one card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray            # object array of torch.device
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``: the name a tensor's ``.device``
    gives, so a mesh's devices compare equal to their tensors'."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible(n: int, devices: Optional[Sequence]) -> list:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh over the visible devices needs CUDA; pass "
                "devices=[torch.device('cpu')] * n to build one on the CPU")
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if len(devices) < n:
        raise ValueError(f"a mesh of {n} devices, but only {len(devices)} "
                         f"given")
    return devices[:n]


def make_mesh(shape: tuple, axes: tuple, devices=None) -> Mesh:
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    arr[:] = _visible(n, devices)
    return Mesh(arr.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices per pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   devices=None) -> Mesh:
    """Small mesh over the visible CUDA devices (or ``devices``)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, model), ("data", "model"), devices)


def data_axes(mesh) -> tuple:
    """Logical batch axes: ('pod','data') when the pod axis exists."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
