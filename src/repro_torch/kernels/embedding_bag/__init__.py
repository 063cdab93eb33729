from repro_torch.kernels.embedding_bag.embedding_bag import \
    embedding_bag_backward_cuda, embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ops import embedding_bag, \
    segment_sum
from repro_torch.kernels.embedding_bag.ref import \
    embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_backward_cuda",
           "embedding_bag_backward_ref", "embedding_bag_cuda",
           "embedding_bag_ref", "segment_sum"]
