from repro_torch.kernels.embedding_bag.embedding_bag import \
    bag_grouping_cuda, embedding_bag_backward_cuda, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ops import bag_grouping, \
    embedding_bag, segment_sum
from repro_torch.kernels.embedding_bag.ref import BagPlan, \
    bag_grouping_ref, embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["BagPlan", "bag_grouping", "bag_grouping_cuda",
           "bag_grouping_ref", "embedding_bag", "embedding_bag_backward_cuda",
           "embedding_bag_backward_ref", "embedding_bag_cuda",
           "embedding_bag_ref", "segment_sum"]
