"""Launch wrappers of the CUDA ``beam_hop`` kernels (``csrc/beam_hop.cu``):
``beam_hop_cuda`` (one hop) and ``beam_hops_cuda`` (the hop loop) in f32
mode, ``beam_hop_lut_cuda`` and ``beam_hops_lut_cuda`` in LUT mode (the pq
and int8 backends). Each counts its own launches.

The f32 loop takes the sharded tier's modes as ``gather_dist`` does: bf16
rows, and the prenorm distance over ``norms``; ``beam_hops_cuda.by_mode``
counts each mode's launches (``gather_dist.MODES``).

The LUT loop has two variants, which compute the same function; ``route``
picks one by shape before the launch, and ``beam_hops_lut_cuda.by_variant``
counts each one's launches:

- ``persistent``: ``grid`` blocks of ``THREADS`` threads, one per SM, walk
  the queries one after another, each query's first ``resident``
  sub-tables copied into shared memory and the rest read through the L2
  (kept there with an evict_last policy), every thread gathering lookups
  (pq and int8 serving);
- ``per_query``: one block per query, one thread per candidate reading the
  LUT from device memory, for shapes the first cannot take (more than
  ``THREADS`` candidates per hop, a staging buffer over a block's shared
  memory, or one LUT's L2 part over ``L2_SHARE`` of the L2).

A grid cut so that the live LUTs' L2 parts fit the L2 lost to a grid of
every SM (int8 at M = 600 on an H100; the probes of
``benchmarks/torch_kernel_times.py``, PERF.md §6): a hop's latency, not
the L2's capacity, bounds the loop.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.analysis.hop_traffic import fused_loop_bytes
from repro_torch.analysis.op_costs import record_kernel
from repro_torch.analysis.roofline import L2_BYTES, SM_COUNT
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.gather_dist.gather_dist import MODES, check_rows, \
    mode_of, rows_vec4_ok, vec4_ok
from repro_torch.kernels.lut_dist.lut_dist import MAX_C, codes_vec4_ok

MAX_ENTRIES = 2048       # ef + R: the merge ranks every entry against all

# The persistent LUT loop's launch plan: one block per SM.
THREADS = 512                # its threads per block (csrc kPersistentThreads)
SMEM_PER_BLOCK = 232_448     # the most one block may take on an H100 (227 KB)
L2_SHARE = 0.8               # of the L2 one LUT's L2 part may fill
CTL_WORDS = 8                # csrc kCtl
LUT_VARIANTS = ("persistent", "per_query")


class LutPlan(NamedTuple):
    variant: str             # "persistent" or "per_query"
    grid: int                # persistent: blocks (each walks queries)
    resident: int            # persistent: sub-tables per LUT in shared memory


def _align16(b: int) -> int:
    return (b + 15) // 16 * 16


def persistent_smem_bytes(ef: int, r: int, m: int, c: int,
                          resident: int) -> int:
    """Shared memory of one persistent block (csrc PersistentLayout): the
    hop's pools and keys, r staged code rows of an odd number of words, the
    (M - resident) x r staging buffer and the resident sub-tables."""
    hop = (ef + r) * 8 + (6 * ef + 3 * r + CTL_WORDS) * 4
    code_words = (m + 3) // 4 | 1
    stage = _align16(_align16(hop) + r * code_words * 4)
    return _align16(stage + (m - resident) * r * 4) + resident * c * 4


@functools.lru_cache(maxsize=None)
def route(m: int, c: int, r: int, ef: int, l2_bytes: int,
          sm_count: int) -> LutPlan:
    """The LUT loop's variant for (M, C) LUTs, R candidates per hop and an
    ef pool, on a card with ``l2_bytes`` of L2 and ``sm_count`` SMs.

    persistent when R <= THREADS, its block fits SMEM_PER_BLOCK with
    nothing resident, and one LUT's L2 part fits ``L2_SHARE`` of the L2;
    then ``resident`` is the most sub-tables (a multiple of 4, or all M)
    that keep the block within SMEM_PER_BLOCK, and ``grid`` one block per
    SM."""
    if r > THREADS or persistent_smem_bytes(ef, r, m, c, 0) > SMEM_PER_BLOCK:
        return LutPlan("per_query", 0, 0)
    resident = next(s for s in [m] + list(range(m // 4 * 4, -1, -4))
                    if persistent_smem_bytes(ef, r, m, c, s) <= SMEM_PER_BLOCK)
    if (m - resident) * c * 4 > L2_SHARE * l2_bytes:
        return LutPlan("per_query", 0, 0)
    return LutPlan("persistent", sm_count, resident)


def _check_plan(name, plan, m, c, r, ef):
    if plan.variant not in LUT_VARIANTS:
        raise ValueError(f"{name}: unknown variant {plan.variant!r}; "
                         f"expected one of {LUT_VARIANTS}")
    if plan.variant == "persistent" and not (
            plan.grid >= 1 and r <= THREADS
            and (plan.resident == m
                 or 0 <= plan.resident < m and plan.resident % 4 == 0)
            and persistent_smem_bytes(ef, r, m, c, plan.resident)
            <= SMEM_PER_BLOCK):
        raise ValueError(f"{name}: the persistent variant cannot take "
                         f"{plan} at M={m}, C={c}, R={r}, ef={ef}")


@functools.lru_cache(maxsize=None)
def _card(device: torch.device):
    if device.type == "meta":           # routed as for an H100
        return L2_BYTES, SM_COUNT
    props = torch.cuda.get_device_properties(device)
    return props.L2_cache_size, props.multi_processor_count


def hops_cost(lanes: int, steps: int, ef: int, r: int, d: int, lut_c: int,
              row_bytes: int, prenorm: bool):
    """(FLOPs, bytes) of one loop launch with every lane running ``steps``
    hops (the shapes alone): the bytes of ``hop_traffic.fused_loop_bytes``;
    per hop R candidates of D elements at 3 FLOPs each in f32 (2 under
    prenorm), one add a code under a LUT (``lut_c`` > 0, D the code
    width)."""
    if lut_c:
        return (lanes * steps * r * d,
                fused_loop_bytes(lanes, steps, ef, r, d, "pq", d, lut_c))
    return ((2 if prenorm else 3) * lanes * steps * r * d,
            fused_loop_bytes(lanes, steps, ef, r, d, row_bytes=row_bytes,
                             prenorm=prenorm))


def _check_operands(name, neighbors, pool_i, pool_d, pool_v, q_or_lut,
                    table, table_dtype, **extra):
    named = {"neighbors": (neighbors, torch.int32),
             "pool_i": (pool_i, torch.int32),
             "pool_d": (pool_d, torch.float32),
             "pool_v": (pool_v, torch.bool),
             "q_or_lut": (q_or_lut, torch.float32),
             "table": (table, table_dtype or table.dtype)}
    named.update({k: (t, torch.int32) for k, t in extra.items()})
    for arg, (t, dt) in named.items():
        if not (t.is_cuda or t.is_meta) or t.device != table.device:
            raise ValueError(f"{name}: {arg} must be on {table.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    nq, ef = pool_i.shape
    n, d = table.shape
    if (pool_d.shape != (nq, ef) or pool_v.shape != (nq, ef)
            or q_or_lut.shape[:2] != (nq, d)
            or any(t.shape != (nq,) for t in extra.values())
            or neighbors.dim() != 2 or neighbors.shape[0] != n or n == 0):
        raise ValueError(f"{name}: shapes disagree: "
                         + ", ".join(f"{k} {tuple(t.shape)}"
                                     for k, (t, _) in named.items()))
    if ef + neighbors.shape[1] > MAX_ENTRIES:
        raise ValueError(f"{name}: ef + R = {ef + neighbors.shape[1]} "
                         f"exceeds {MAX_ENTRIES}")


def _check_lut(name, lut):
    if lut.dim() != 3 or not 1 <= lut.shape[2] <= MAX_C:
        raise ValueError(f"{name}: lut must be (Q, M, C) with C <= {MAX_C}, "
                         f"got {tuple(lut.shape)}")


def _pool_like(nq, ef, dev):
    return (torch.empty((nq, ef), dtype=torch.int32, device=dev),
            torch.empty((nq, ef), dtype=torch.float32, device=dev),
            torch.empty((nq, ef), dtype=torch.bool, device=dev))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def beam_hop_cuda(sel, neighbors, pool_i, pool_d, pool_v, queries, db):
    """One fused f32 hop over all Q lanes; see ``ref.beam_hop_ref``."""
    if queries.dim() != 2:
        raise ValueError("beam_hop_cuda: queries must be (Q, D)")
    _check_operands("beam_hop_cuda", neighbors, pool_i, pool_d, pool_v,
                    queries, db, torch.float32, sel=sel)
    lib = cuda_lib.library()
    nq, ef = pool_i.shape
    n, d = db.shape
    out = _pool_like(nq, ef, db.device) + (
        torch.empty((nq, 2), dtype=torch.int32, device=db.device),)
    code = lib.beam_hop_f32(
        sel.data_ptr(), neighbors.data_ptr(), pool_i.data_ptr(),
        pool_d.data_ptr(), pool_v.data_ptr(), queries.data_ptr(),
        db.data_ptr(), *(t.data_ptr() for t in out), nq, n,
        neighbors.shape[1], d, ef, int(vec4_ok(d, queries, db)), _stream(db))
    cuda_lib.check(code, "beam_hop_f32")
    beam_hop_cuda.launches += 1
    return out


def beam_hop_lut_cuda(sel, neighbors, pool_i, pool_d, pool_v, lut, codes):
    """One fused LUT-mode hop: lut (Q, M, C) f32, codes (N, M) uint8; see
    ``ref.beam_hop_ref`` with ``dist_backend="pq"|"int8"``."""
    _check_lut("beam_hop_lut_cuda", lut)
    _check_operands("beam_hop_lut_cuda", neighbors, pool_i, pool_d, pool_v,
                    lut, codes, torch.uint8, sel=sel)
    lib = cuda_lib.library()
    nq, ef = pool_i.shape
    n, m = codes.shape
    out = _pool_like(nq, ef, codes.device) + (
        torch.empty((nq, 2), dtype=torch.int32, device=codes.device),)
    code = lib.beam_hop_lut(
        sel.data_ptr(), neighbors.data_ptr(), pool_i.data_ptr(),
        pool_d.data_ptr(), pool_v.data_ptr(), lut.data_ptr(),
        codes.data_ptr(), *(t.data_ptr() for t in out), nq, n,
        neighbors.shape[1], m, lut.shape[2], ef,
        int(codes_vec4_ok(m, codes)), _stream(codes))
    cuda_lib.check(code, "beam_hop_lut")
    beam_hop_lut_cuda.launches += 1
    return out


def _hops(name, neighbors, pool_i, pool_d, pool_v, hops, gathered, dup,
          stale, q_or_lut, table, k, max_iters, max_steps, patience, eps,
          plan=None, norms=None):
    """Launch the loop kernel (LUT mode: on ``plan``, else on ``route``'s;
    f32 mode: f32 or bf16 rows, prenorm with ``norms``); returns the 9
    outputs of ``beam_hops_ref`` and the plan."""
    for arg, v in (("k", k), ("max_iters", max_iters),
                   ("max_steps", max_steps)):
        if not 0 <= v < 2 ** 31:
            raise ValueError(f"{name}: {arg} = {v} out of range")
    lut = q_or_lut.dim() == 3
    if lut:
        _check_lut(name, q_or_lut)
    else:
        check_rows(name, table, norms)
    _check_operands(name, neighbors, pool_i, pool_d, pool_v, q_or_lut, table,
                    torch.uint8 if lut else None, hops=hops,
                    gathered=gathered, dup=dup, stale=stale)
    nq, ef = pool_i.shape
    n, d = table.shape
    if lut:
        shape = (d, q_or_lut.shape[2], neighbors.shape[1], ef)
        if plan is None:
            plan = route(*shape, *_card(table.device))
        else:
            _check_plan(name, plan, *shape)
    dev = table.device
    out = _pool_like(nq, ef, dev) + tuple(
        torch.empty((nq,), dtype=torch.int32, device=dev)
        for _ in range(5)) + (torch.empty((nq,), dtype=torch.bool,
                                          device=dev),)
    record_kernel("beam_hops", *hops_cost(
        nq, max_steps, ef, neighbors.shape[1], d,
        q_or_lut.shape[2] if lut else 0, table.element_size(),
        norms is not None))
    if dev.type == "meta":
        return out, plan
    lib = cuda_lib.library()
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    ins = ptrs((neighbors, pool_i, pool_d, pool_v, hops, gathered, dup,
                stale))
    outs = ptrs(out)
    head = (ins, outs, q_or_lut.data_ptr(), table.data_ptr(), nq, n,
            neighbors.shape[1], d)
    tail = (ef, k, max_iters, max_steps,
            -1 if patience is None else int(patience), float(eps))
    if lut:
        c = q_or_lut.shape[2]
        lut_vec4 = (d * c) % 4 == 0 and q_or_lut.data_ptr() % 16 == 0
        code = lib.beam_hops_lut(*head, c, *tail,
                                 int(codes_vec4_ok(d, table)),
                                 plan.grid if plan.variant == "persistent"
                                 else 0, plan.resident, int(lut_vec4),
                                 _stream(table))
    else:
        head = head[:4] + (None if norms is None else norms.data_ptr(),) \
            + head[4:]
        code = lib.beam_hops_f32(*head, *tail,
                                 int(rows_vec4_ok(d, q_or_lut, table)),
                                 int(table.dtype == torch.bfloat16),
                                 _stream(table))
    cuda_lib.check(code, "beam_hops_lut" if lut else "beam_hops_f32")
    return out, plan


def beam_hops_cuda(neighbors, pool_i, pool_d, pool_v, hops, gathered, dup,
                   stale, queries, db, *, k: int, max_iters: int,
                   max_steps: int, patience: Optional[int] = None,
                   eps: float = 0.0, norms: Optional[torch.Tensor] = None):
    """The f32 hop loop, up to ``max_steps`` hops per lane in one launch:
    ``db`` f32 or bf16 rows, ``norms`` (N,) f32 for the prenorm distance;
    see ``ref.beam_hops_ref``. Meta operands: the outputs, the cost of
    ``max_steps`` hops for every lane recorded, no launch."""
    if queries.dim() != 2:
        raise ValueError("beam_hops_cuda: queries must be (Q, D)")
    out, _ = _hops("beam_hops_cuda", neighbors, pool_i, pool_d, pool_v,
                   hops, gathered, dup, stale, queries, db, k, max_iters,
                   max_steps, patience, eps, norms=norms)
    if db.is_meta:
        return out
    beam_hops_cuda.launches += 1
    beam_hops_cuda.by_mode[mode_of(db, norms)] += 1
    return out


def beam_hops_lut_cuda(neighbors, pool_i, pool_d, pool_v, hops, gathered,
                       dup, stale, lut, codes, *, k: int, max_iters: int,
                       max_steps: int, patience: Optional[int] = None,
                       eps: float = 0.0, plan: Optional[LutPlan] = None):
    """The LUT-mode hop loop: lut (Q, M, C) f32, codes (N, M) uint8; see
    ``ref.beam_hops_ref``. On ``route``'s plan unless one is forced (tests,
    measurements); a forced plan must fit the kernel."""
    if codes.is_meta:
        raise NotImplementedError("beam_hops_lut_cuda: no meta branch (no "
                                  "dry-run cell reaches the LUT loop)")
    out, plan = _hops("beam_hops_lut_cuda", neighbors, pool_i, pool_d,
                      pool_v, hops, gathered, dup, stale, lut, codes, k,
                      max_iters, max_steps, patience, eps, plan)
    beam_hops_lut_cuda.launches += 1
    beam_hops_lut_cuda.by_variant[plan.variant] += 1
    return out


beam_hop_cuda.launches = 0
beam_hop_lut_cuda.launches = 0
beam_hops_cuda.launches = 0
beam_hops_cuda.by_mode = dict.fromkeys(MODES, 0)
beam_hops_lut_cuda.launches = 0
beam_hops_lut_cuda.by_variant = dict.fromkeys(LUT_VARIANTS, 0)
