from repro_torch.kernels.alpha_scan.alpha_scan import alpha_scan_cuda
from repro_torch.kernels.alpha_scan.ops import alpha_scan
from repro_torch.kernels.alpha_scan.ref import alpha_scan_ref

__all__ = ["alpha_scan", "alpha_scan_cuda", "alpha_scan_ref"]
