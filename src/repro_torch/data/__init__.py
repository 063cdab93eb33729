from repro_torch.data.synthetic import clustered_vectors, queries_like

__all__ = ["clustered_vectors", "queries_like"]
