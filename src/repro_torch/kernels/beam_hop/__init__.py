from repro_torch.kernels.beam_hop.beam_hop import beam_hop_cuda, \
    beam_hop_lut_cuda, beam_hops_cuda, beam_hops_lut_cuda
from repro_torch.kernels.beam_hop.ops import beam_hop, beam_hops
from repro_torch.kernels.beam_hop.ref import beam_hop_ref, beam_hops_ref, \
    lane_live, merge_one, select_frontier

__all__ = ["beam_hop", "beam_hop_cuda", "beam_hop_lut_cuda", "beam_hop_ref",
           "beam_hops", "beam_hops_cuda", "beam_hops_lut_cuda",
           "beam_hops_ref", "lane_live", "merge_one", "select_frontier"]
