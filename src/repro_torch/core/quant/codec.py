"""Vector codecs for quantized traversal (the reference's
``core/quant/codec.py``).

A codec replaces the f32 rows a hop gathers with uint8 codes plus a
per-query lookup table (LUT), so one hop reads R rows of M bytes instead
of D*4; an exact f32 rerank of the beam's survivors finishes the search.
Both codecs serve one contract, so one LUT kernel (``kernels/lut_dist``,
and ``kernels/beam_hop`` in LUT mode) serves either:

  * ``encode(data)``  -> (N, M) uint8 codes;
  * ``lut(queries)``  -> (Q, M, C) f32 per-query sub-distance tables;
  * approx sq-distance(q, n) = sum_m lut[q, m, codes[n, m]].

``PQCodec`` is product quantization: M sub-spaces x C centroids trained
with the port's k-means. ``Int8Codec`` is scalar quantization: per-dim
scale and zero-point; its LUT is the dsub=1, uniform-grid case of PQ's
(M = D). The arithmetic follows the reference op for op (``zero + scale *
levels`` as a multiply and an add, ``torch.round`` rounding half to even
like ``jnp.round``), so the tables and codes agree with it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distances import l2_topk
from repro_torch.core.kmeans import kmeans, kmeanspp_init

# what a search may traverse: the f32 rows, or one codec's uint8 codes
DIST_BACKENDS = ("f32", "pq", "int8")


def check_dist_backend(dist_backend: str) -> str:
    """``dist_backend`` if it names a traversal, else ValueError; the
    entry points call it, the layers below take what they were given."""
    if dist_backend not in DIST_BACKENDS:
        raise ValueError(f"unknown dist_backend {dist_backend!r} "
                         f"(expected one of {DIST_BACKENDS})")
    return dist_backend


def default_pq_m(dim: int) -> int:
    """Largest divisor of ``dim`` no bigger than dim // 2 (2-dim+ subspaces);
    1 for a prime. dim=600 -> 300, dim=32 -> 16."""
    for m in range(dim // 2, 0, -1):
        if dim % m == 0:
            return m
    return 1


# elements of the (rows, M, C, dsub) difference tensor pq_lut makes at once
LUT_CHUNK_ELEMS = 1 << 28


def pq_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(Q, D) queries x (M, C, dsub) codebooks -> (Q, M, C) sq-dist LUT:
    entry [q, m, c] is the squared L2 between query q's m-th sub-vector and
    centroid c of sub-space m. Query rows go in chunks that keep the
    difference tensor under LUT_CHUNK_ELEMS elements (each entry's
    arithmetic is the same whatever the chunk)."""
    qn = queries.shape[0]
    m, c, dsub = codebooks.shape
    books = codebooks[None].float()
    step = max(1, LUT_CHUNK_ELEMS // max(m * c * dsub, 1))
    out = []
    for s in range(0, max(qn, 1), step):
        qsub = queries[s:s + step].reshape(-1, m, dsub).float()
        diff = qsub[:, :, None, :] - books
        out.append((diff * diff).sum(-1))
    return out[0] if len(out) == 1 else torch.cat(out)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(N, M) codes x (M, C, dsub) codebooks -> (N, M*dsub) reconstruction."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(n, -1)


class PQCodec:
    """Product quantizer: M sub-spaces, C <= 256 k-means centroids each.

    ``fit`` trains the codebooks only; the index encodes its base with
    ``encode`` (the reference's ``fit`` also caches the training codes —
    the same array).
    """

    def __init__(self, m: int, n_centroids: int = 256):
        if m < 1:
            raise ValueError(f"pq m={m} must be >= 1")
        self.m = m
        self.n_centroids = n_centroids
        self.codebooks: Optional[torch.Tensor] = None   # (M, C, dsub)

    def fit(self, data: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            init_centroids: Optional[torch.Tensor] = None):
        """k-means (8 Lloyd steps, as the reference's) per sub-space. The
        k-means++ seeds of all M sub-spaces are drawn in one batched run
        from ``generator`` (a CPU generator, default seeded with 0), unless
        ``init_centroids`` (M, C, dsub) hands them in (a test passes the
        reference's draws)."""
        n, d = data.shape
        if d % self.m != 0:
            raise ValueError(
                f"PQ m={self.m} does not divide dim={d}; pick m from the "
                f"divisors of the (post-PCA) dimensionality")
        k = min(self.n_centroids, n)
        sub = data.float().reshape(n, self.m, d // self.m).transpose(0, 1)
        if init_centroids is None:
            generator = generator if generator is not None else \
                torch.Generator().manual_seed(0)
            init_centroids = kmeanspp_init(generator, sub.contiguous(), k)
        init = torch.as_tensor(init_centroids, dtype=torch.float32,
                               device=data.device)
        self.codebooks = torch.stack([
            kmeans(None, sub[j], k, iters=8,
                   init_centroids=init[j]).centroids
            for j in range(self.m)])
        return self

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        n, d = data.shape
        sub = data.float().reshape(n, self.m, d // self.m)
        # the nearest-centroid arithmetic k-means assigns with
        return torch.stack([l2_topk(sub[:, j], self.codebooks[j], 1)[1][:, 0]
                            .to(torch.uint8) for j in range(self.m)], dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return pq_decode(codes, self.codebooks)

    def lut(self, queries: torch.Tensor) -> torch.Tensor:
        return pq_lut(queries, self.codebooks)

    def memory_bytes(self) -> int:
        return int(self.codebooks.numel() * 4)

    @property
    def code_bytes(self) -> int:
        return self.m


_SQ8_LEVELS = 254          # codes occupy [-127, 127] around the zero-point
_SQ8_ZERO_CODE = 127       # uint8 storage offset: stored = signed + 127


def _sq8_encode(data, scale, zero):
    q = torch.round((data.float() - zero) / scale)
    q = q.clamp(-_SQ8_ZERO_CODE, _SQ8_ZERO_CODE)
    return (q + _SQ8_ZERO_CODE).to(torch.uint8)


def _sq8_lut(queries, scale, zero):
    # grid[d, v] = dequant(v, d): the 256 reconstruction levels per dim
    # (entry 255 is out of the symmetric range but kept for a pow2 C); a
    # multiply, then an add, as the reference rounds them
    levels = torch.arange(256, dtype=torch.float32,
                          device=scale.device) - _SQ8_ZERO_CODE
    grid = zero[:, None] + scale[:, None] * levels[None, :]   # (D, 256)
    diff = queries.float()[:, :, None] - grid[None]
    return diff * diff                                        # (Q, D, 256)


class Int8Codec:
    """Per-dim scalar quantizer: code = clip(round((x - zero_d) / scale_d),
    -127, 127), stored as uint8 (+127). The LUT treats every dim as a
    256-level sub-quantizer, so the LUT kernels serve it as they serve PQ."""

    def __init__(self):
        self.scale: Optional[torch.Tensor] = None   # (D,) f32
        self.zero: Optional[torch.Tensor] = None    # (D,) f32 zero-point

    def fit(self, data: torch.Tensor, *,
            generator: Optional[torch.Generator] = None):
        """Deterministic: min/max per dim (``generator`` is unused)."""
        del generator
        x = data.float()
        lo, hi = x.min(0).values, x.max(0).values
        self.zero = (lo + hi) * 0.5
        self.scale = ((hi - lo) / _SQ8_LEVELS).clamp_min(1e-12)
        return self

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        return _sq8_encode(data, self.scale, self.zero)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        signed = codes.float() - _SQ8_ZERO_CODE
        return self.zero[None] + signed * self.scale[None]

    def lut(self, queries: torch.Tensor) -> torch.Tensor:
        return _sq8_lut(queries, self.scale, self.zero)

    def memory_bytes(self) -> int:
        return int((self.scale.numel() + self.zero.numel()) * 4)

    @property
    def code_bytes(self) -> int:
        return int(self.scale.shape[0])


def make_codec(dist_backend: str, dim: int, pq_m: int = 0,
               n_centroids: int = 256):
    """Codec for a ``dist_backend`` name ("pq" | "int8"); pq_m=0 -> auto."""
    if dist_backend == "pq":
        return PQCodec(pq_m or default_pq_m(dim), n_centroids)
    if dist_backend == "int8":
        return Int8Codec()
    raise ValueError(
        f"unknown dist_backend {dist_backend!r} (expected 'pq' | 'int8'; "
        f"'f32' means unquantized traversal, which needs no codec)")
