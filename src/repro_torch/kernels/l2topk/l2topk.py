"""Launch wrapper of the CUDA ``l2topk`` kernels (``csrc/l2topk.cu``).

Four variants compute the same function; ``route`` picks one by shape,
explicitly, and each counts its own launches in
``l2topk_cuda.by_variant`` (``l2topk_cuda.launches`` is their sum):

- ``small``: the whole database in shared memory, one thread per query,
  top-k in registers (N <= 256, D <= 8, k <= 16: PQ's sub-space codebooks).
- ``tc``: 3xTF32 products on the tensor cores (wgmma), for many queries
  against a large database (AntiHub, the kNN graph, the ground truth).
- ``tile``: f32 FMA tiles on the CUDA cores, for the rest (the medoid's one
  query, the 64-centroid assignments, 64 < k <= 128).
- ``wide``: the tile variant's distances with each query's running top-k in
  global memory, for any k <= N (k > 128: ``FlatIndex.search``, the exact
  kNN table at wide k).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis.op_costs import record_kernel
from repro_torch.analysis.roofline import SM_COUNT
from repro_torch.kernels import card_or_meta, cuda_lib

MAX_K = 128                  # the tile variant's list capacity
# wide: at most this many scratch keys (splits x Q x k, 8 bytes each) for
# its per-split running lists; fewer splits above it
WIDE_SCRATCH_KEYS = 1 << 26
BLOCK_Q, BLOCK_N = 64, 128   # the tile variant's query and database tiles
TC_BLOCK_Q, TC_BLOCK_N = 128, 256   # the tc variant's
TC_K = 16                    # tc: columns per stage; rows padded to it
TC_MAX_K = 64                # tc: its per-row lists in shared memory
TC_MIN_Q, TC_MIN_N, TC_MIN_D = 128, 1024, 32
SMALL_MAX_N, SMALL_MAX_D, SMALL_MAX_K = 256, 8, 16
VARIANTS = ("tile", "small", "tc", "wide")   # the C entry point's codes


class Plan(NamedTuple):
    variant: str
    splits: int
    tiles_per_split: int


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(nq: int, n: int, sm_count: int, block_q: int = BLOCK_Q,
               block_n: int = BLOCK_N, blocks_per_sm: int = 2,
               max_splits: Optional[int] = None):
    """(splits, tiles per split): as many database splits as keep the
    grid within one wave of ``blocks_per_sm`` blocks per SM (a second,
    part-filled wave would idle most of the card), at most ``max_splits``,
    and no split left empty."""
    q_tiles = -(-nq // block_q)
    n_tiles = -(-n // block_n)
    want = min(n_tiles, max(1, blocks_per_sm * sm_count // q_tiles))
    if max_splits is not None:
        want = max(1, min(want, max_splits))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def variant_for(nq: int, n: int, d: int, k: int) -> str:
    """The variant a (Q, N, D, k) call takes (k already cut to N)."""
    if k > MAX_K:
        return "wide"
    if n <= SMALL_MAX_N and d <= SMALL_MAX_D and k <= SMALL_MAX_K:
        return "small"
    if (k <= TC_MAX_K and nq >= TC_MIN_Q and n >= TC_MIN_N
            and d >= TC_MIN_D):
        return "tc"
    return "tile"


def route(nq: int, n: int, d: int, k: int, sm_count: int,
          variant: Optional[str] = None) -> Plan:
    """The variant and its database split for a call of ``nq`` queries
    against ``n`` rows of ``d`` floats, ``k`` (<= n) neighbours each.
    ``variant`` forces one (tests, measurements); it must take the shape."""
    if variant is None:
        variant = variant_for(nq, n, d, k)
    elif variant not in VARIANTS:
        raise ValueError(f"l2topk_cuda: unknown variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    elif variant == "small" and not (n <= SMALL_MAX_N and d <= SMALL_MAX_D
                                     and k <= SMALL_MAX_K):
        raise ValueError(f"l2topk_cuda: the small variant takes N <= "
                         f"{SMALL_MAX_N}, D <= {SMALL_MAX_D}, k <= "
                         f"{SMALL_MAX_K}; got N={n}, D={d}, k={k}")
    elif variant == "tc" and k > TC_MAX_K:
        raise ValueError(f"l2topk_cuda: the tc variant takes k <= "
                         f"{TC_MAX_K}; got k={k}")
    elif variant == "tile" and k > MAX_K:
        raise ValueError(f"l2topk_cuda: the tile variant takes k <= "
                         f"{MAX_K}; got k={k}")
    if variant == "small":
        return Plan(variant, 1, 1)
    if variant == "wide":   # about k rows or more per split's k-key list
        return Plan(variant, *split_plan(
            nq, n, sm_count,
            max_splits=min(n // k, WIDE_SCRATCH_KEYS // (nq * k))))
    if variant == "tc":            # one block per SM (its shared memory)
        return Plan(variant, *split_plan(nq, n, sm_count, TC_BLOCK_Q,
                                         TC_BLOCK_N, blocks_per_sm=1))
    return Plan(variant, *split_plan(nq, n, sm_count))


def _check_operands(queries, database, k):
    if not card_or_meta(queries, database):
        raise ValueError("l2topk_cuda: queries and database must be on CUDA "
                         "(or both on meta)")
    if queries.device != database.device:
        raise ValueError("l2topk_cuda: operands on different devices")
    if queries.dtype != torch.float32 or database.dtype != torch.float32:
        raise TypeError("l2topk_cuda: queries and database must be float32")
    if queries.dim() != 2 or database.dim() != 2 \
            or queries.shape[1] != database.shape[1]:
        raise ValueError(f"l2topk_cuda: expected (Q, D) and (N, D), got "
                         f"{tuple(queries.shape)} and "
                         f"{tuple(database.shape)}")
    if database.shape[0] == 0 or database.shape[1] == 0:
        raise ValueError("l2topk_cuda: empty database")
    if not (queries.is_contiguous() and database.is_contiguous()):
        raise ValueError("l2topk_cuda: operands must be contiguous")
    if k < 1:
        raise ValueError(f"l2topk_cuda: k={k} must be >= 1")


def cost(nq: int, n: int, d: int, k: int, variant: str):
    """(FLOPs, bytes, dtype) of one call: the queries and the database
    read once, the (Q, k) distances and ids written; 2 Q N D FLOPs in
    f32, or 3 x that on the TF32 tensor cores (the tc variant's 3xTF32)."""
    nbytes = (nq + n) * d * 4 + nq * k * 8
    if variant == "tc":
        return 6 * nq * n * d, nbytes, "tf32"
    return 2 * nq * n * d, nbytes, "f32"


def l2topk_cuda(queries: torch.Tensor, database: torch.Tensor, k: int,
                variant: Optional[str] = None):
    """queries (Q, D) f32, database (N, D) f32 -> (dists (Q, k) f32
    ascending, ids (Q, k) int32), ties by lower id; k is cut to N. The
    variant is ``route``'s unless one is forced. Meta operands: the
    outputs and the launch's scratch allocated, its cost recorded (routed
    for an H100, ``roofline.SM_COUNT``), no launch."""
    _check_operands(queries, database, k)
    nq, d = queries.shape
    n = database.shape[0]
    k = min(k, n)
    dev = database.device
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_d, out_i
    plan = route(nq, n, d, k, SM_COUNT if dev.type == "meta"
                 else _sm_count(dev), variant)
    norms = split = partial = None
    if plan.variant != "small":
        norms = torch.empty(nq + n, dtype=torch.float32, device=dev)
    if plan.variant == "tc":
        dp = -(-d // TC_K) * TC_K
        split = torch.empty(2 * (nq + n) * dp, dtype=torch.float32,
                            device=dev)
    if plan.splits > 1 or plan.variant == "wide":   # wide: its lists
        partial = torch.empty((plan.splits, nq, k), dtype=torch.int64,
                              device=dev)
    record_kernel("l2topk", *cost(nq, n, d, k, plan.variant))
    if dev.type == "meta":
        return out_d, out_i
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = cuda_lib.library()
    code = lib.l2topk_f32(
        queries.data_ptr(), database.data_ptr(), ptr(norms), ptr(split),
        ptr(partial), out_d.data_ptr(), out_i.data_ptr(), nq, n, d, k,
        VARIANTS.index(plan.variant), plan.splits, plan.tiles_per_split,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(code, f"l2topk_f32 ({plan.variant})")
    # the small kernel alone; else the norms pass, the tile, tc or wide
    # kernel, and the merge when the database is split
    count = 1 if plan.variant == "small" else (3 if plan.splits > 1 else 2)
    l2topk_cuda.launches += count
    l2topk_cuda.by_variant[plan.variant] += count
    return out_d, out_i


def reset_launches() -> None:
    """Zero the total and every variant's launch count."""
    l2topk_cuda.launches = 0
    l2topk_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


reset_launches()
