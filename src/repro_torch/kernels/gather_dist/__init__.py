from repro_torch.kernels.gather_dist.gather_dist import gather_dist_cuda
from repro_torch.kernels.gather_dist.ops import gather_dist
from repro_torch.kernels.gather_dist.ref import gather_dist_ref

__all__ = ["gather_dist", "gather_dist_cuda", "gather_dist_ref"]
