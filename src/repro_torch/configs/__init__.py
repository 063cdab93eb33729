"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

It lists what the port runs: the paper's ANN workload and the two-tower
retrieval model. Every other id of the reference's registry raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import ann_laion, two_tower_retrieval
from repro_torch.configs.base import (  # noqa: F401
    ANNConfig, ArchSpec, RecsysConfig, ShapeConfig, RECSYS_SHAPES,
)

_REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in [two_tower_retrieval.SPEC, ann_laion.SPEC]
}

_LM_GNN = "ROADMAP Queue 1 item 10.6 (LM and GNN models)"
NOT_PORTED: Dict[str, str] = {
    "qwen3-32b": _LM_GNN,
    "qwen2-1.5b": _LM_GNN,
    "mistral-nemo-12b": _LM_GNN,
    "deepseek-v2-236b": _LM_GNN,
    "deepseek-moe-16b": _LM_GNN,
    "dimenet": _LM_GNN,
    "sasrec": "ROADMAP Queue 1 item 10.2 (SASRec serving)",
    "din": "ROADMAP Queue 1 item 10.3 (DIN serving)",
    "dlrm-mlperf": "ROADMAP Queue 1 item 10.4 (DLRM, with item 9's "
                   "row-sharded lookup)",
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet ({NOT_PORTED[arch_id]}); "
            f"the port runs {list_archs()}")
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {list_archs()}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)
