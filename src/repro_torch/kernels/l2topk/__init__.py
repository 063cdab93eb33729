from repro_torch.kernels.l2topk.l2topk import l2topk_cuda
from repro_torch.kernels.l2topk.ops import l2_topk
from repro_torch.kernels.l2topk.ref import l2_topk_ref

__all__ = ["l2_topk", "l2_topk_ref", "l2topk_cuda"]
