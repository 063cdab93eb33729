from repro_torch.kernels.topk_merge.ops import topk_merge, topk_pool
from repro_torch.kernels.topk_merge.ref import (
    mark_dups, topk_merge_ref, topk_pool_ref,
)
from repro_torch.kernels.topk_merge.topk_merge import topk_merge_cuda

__all__ = ["mark_dups", "topk_merge", "topk_merge_cuda", "topk_merge_ref",
           "topk_pool", "topk_pool_ref"]
