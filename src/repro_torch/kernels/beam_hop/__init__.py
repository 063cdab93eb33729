from repro_torch.kernels.beam_hop.beam_hop import beam_hop_cuda, \
    beam_hop_lut_cuda
from repro_torch.kernels.beam_hop.ops import beam_hop
from repro_torch.kernels.beam_hop.ref import beam_hop_ref, merge_one

__all__ = ["beam_hop", "beam_hop_cuda", "beam_hop_lut_cuda", "beam_hop_ref",
           "merge_one"]
