from repro_torch.data.synthetic import clustered_vectors, lm_batch, \
    queries_like, random_graph, recsys_batch

__all__ = ["clustered_vectors", "lm_batch", "queries_like", "random_graph",
           "recsys_batch"]
