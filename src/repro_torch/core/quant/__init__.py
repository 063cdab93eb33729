"""Quantized traversal codecs (PQ / scalar int8) for the serving hot path."""
from repro_torch.core.quant.codec import (
    DIST_BACKENDS,
    Int8Codec,
    PQCodec,
    check_dist_backend,
    default_pq_m,
    make_codec,
    pq_decode,
    pq_lut,
)

__all__ = ["DIST_BACKENDS", "Int8Codec", "PQCodec", "check_dist_backend",
           "default_pq_m", "make_codec", "pq_decode", "pq_lut"]
