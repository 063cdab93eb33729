"""Architecture registry of the port: ``get_arch(id)`` / ``list_archs()``.

It lists what the port runs: the paper's ANN workload, the four recsys
models (DLRM, two-tower retrieval, SASRec, DIN) and the three dense LMs
(qwen2-1.5b, mistral-nemo-12b, qwen3-32b). The reference's MoE / MLA and
GNN ids raise ``NotImplementedError`` naming the ROADMAP item that brings
them.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import ann_laion, din, dlrm_mlperf, \
    mistral_nemo_12b, qwen2_1_5b, qwen3_32b, sasrec, two_tower_retrieval
from repro_torch.configs.base import (  # noqa: F401
    ANNConfig, ArchSpec, LMConfig, RecsysConfig, ShapeConfig, LM_SHAPES,
    RECSYS_SHAPES, reduced_lm,
)

_REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in [
        qwen3_32b.SPEC, qwen2_1_5b.SPEC, mistral_nemo_12b.SPEC,
        dlrm_mlperf.SPEC, two_tower_retrieval.SPEC, sasrec.SPEC, din.SPEC,
        ann_laion.SPEC]
}

MOE_MLA = "ROADMAP Queue 1 item 10.6b (MoE and MLA)"
GNN = "ROADMAP Queue 1 item 10.6c (DimeNet)"
NOT_PORTED: Dict[str, str] = {
    "deepseek-v2-236b": MOE_MLA,
    "deepseek-moe-16b": MOE_MLA,
    "dimenet": GNN,
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
