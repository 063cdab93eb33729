from repro_torch.kernels.lut_dist.lut_dist import lut_dist_cuda
from repro_torch.kernels.lut_dist.ops import lut_dist
from repro_torch.kernels.lut_dist.ref import lut_dist_ref

__all__ = ["lut_dist", "lut_dist_cuda", "lut_dist_ref"]
