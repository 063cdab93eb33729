"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

It lists what the port runs: the paper's ANN workload and the four recsys
models (DLRM, two-tower retrieval, SASRec, DIN). The reference's LM and
GNN ids raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import ann_laion, din, dlrm_mlperf, sasrec, \
    two_tower_retrieval
from repro_torch.configs.base import (  # noqa: F401
    ANNConfig, ArchSpec, RecsysConfig, ShapeConfig, RECSYS_SHAPES,
)

_REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in [
        dlrm_mlperf.SPEC, two_tower_retrieval.SPEC, sasrec.SPEC, din.SPEC,
        ann_laion.SPEC]
}

_LM_GNN = "ROADMAP Queue 1 item 10.6 (LM and GNN models)"
NOT_PORTED: Dict[str, str] = {
    "qwen3-32b": _LM_GNN,
    "qwen2-1.5b": _LM_GNN,
    "mistral-nemo-12b": _LM_GNN,
    "deepseek-v2-236b": _LM_GNN,
    "deepseek-moe-16b": _LM_GNN,
    "dimenet": _LM_GNN,
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
