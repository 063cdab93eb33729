"""Launch wrappers of the CUDA ``embedding_bag`` kernels
(``csrc/embedding_bag.cu``): the bag, the grouping of its ids (a plan), and
its gradient with respect to the table over a plan."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.analysis.op_costs import record_kernel
from repro_torch.kernels import card_or_meta, cuda_lib
from repro_torch.kernels.embedding_bag.ref import BagPlan

_DTYPES = (torch.float32, torch.bfloat16)
RADIX_TILE, RADIX_BINS = 2048, 256     # csrc kRadixTile, kRadixBins


def grouping_scratch_words(n: int) -> int:
    """int32 scratch words ``bag_grouping`` takes for n ids (csrc
    ``bag_grouping_scratch_words``: two key and two value buffers, each
    tile's digit counts, the totals and the tile heads)."""
    tiles = -(-n // RADIX_TILE)
    return 4 * n + RADIX_BINS * tiles + RADIX_BINS + tiles


def bag_cost(b: int, bag_len: int, d: int, row_bytes: int,
             weighted: bool):
    """(FLOPs, bytes) of one bag launch (the shapes alone): the ids (and
    weights) read, every member's row read (each id counted, the upper
    bound of the distinct rows), the (B, D) f32 bags written; a multiply
    and an add a member element."""
    n = b * bag_len
    return 2 * n * d, n * 4 * (2 if weighted else 1) + n * d * row_bytes \
        + b * d * 4


def grouping_cost(n: int, num_rows: int):
    """(FLOPs, bytes) of one grouping: the ids read once and the plan
    written once, its rows and starts at their allocated bound
    min(n, V) (U stays on the card: reading it would cost a host sync)."""
    cap = min(n, num_rows)
    return 0, n * 4 + (n + 2 * cap + 3) * 4


def backward_cost(b: int, bag_len: int, d: int, num_rows: int,
                  weighted: bool, store: bool):
    """(FLOPs, bytes) of one backward launch: the (B, D) gradient, the
    ids, the plan (and weights) read once, the touched rows at their
    bound min(B L, V) written once (read too when adding into ``out``);
    a multiply and an add a member element."""
    n = b * bag_len
    cap = min(n, num_rows)
    nbytes = b * d * 4 + n * 4 * (2 if weighted else 1) \
        + (n + 2 * cap + 3) * 4 + cap * d * 4 * (1 if store else 2)
    return 2 * n * d, nbytes


def _check_operands(table, ids, weights, combiner):
    if combiner not in ("sum", "mean"):
        raise ValueError(f"embedding_bag_cuda: unknown combiner "
                         f"{combiner!r}")
    ts = (table, ids) if weights is None else (table, ids, weights)
    if not card_or_meta(*ts):
        raise ValueError("embedding_bag_cuda: every operand must be on CUDA "
                         "(or all on meta)")
    if any(t.device != table.device for t in ts):
        raise ValueError("embedding_bag_cuda: operands on different devices")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embedding_bag_cuda: table must be float32 or "
                        f"bfloat16, got {table.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError("embedding_bag_cuda: ids must be int32")
    if weights is not None and weights.dtype != torch.float32:
        raise TypeError("embedding_bag_cuda: weights must be float32")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"embedding_bag_cuda: expected (V, D) and (B, L), "
                         f"got {tuple(table.shape)} and {tuple(ids.shape)}")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"embedding_bag_cuda: weights {tuple(weights.shape)}"
                         f" differ from ids {tuple(ids.shape)}")
    if table.shape[0] == 0:
        raise ValueError("embedding_bag_cuda: empty table")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("embedding_bag_cuda: operands must be contiguous")


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       combiner: str = "sum") -> torch.Tensor:
    """table (V, D) f32/bf16, ids (B, L) int32 (-1 pads), weights (B, L)
    f32 or None -> (B, D) f32. Ids >= V are outside the contract: they are
    not checked (a check would cost a host sync) and read row V - 1. Meta
    operands: the output and the cost, no launch."""
    _check_operands(table, ids, weights, combiner)
    b, bag_len = ids.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    record_kernel("embedding_bag", *bag_cost(b, bag_len, d,
                                             table.element_size(),
                                             weights is not None))
    if table.is_meta:
        return out
    vec4 = d % 4 == 0 and table.data_ptr() % (4 * table.element_size()) == 0
    lib = cuda_lib.library()
    code = lib.embedding_bag(
        table.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        b, bag_len, v, d, int(combiner == "mean"), int(vec4),
        int(table.dtype == torch.bfloat16),
        torch.cuda.current_stream(table.device).cuda_stream)
    cuda_lib.check(code, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0


def bag_grouping_cuda(ids: torch.Tensor, num_rows: int) -> BagPlan:
    """The plan of ``ids`` (int32 on CUDA, any shape; flattened) over
    ``num_rows`` rows, built on the card with no host sync: pads (< 0)
    dropped, ids >= num_rows folded onto num_rows - 1, positions grouped
    stably by id (a radix sort over the ids' ceil(log2 num_rows) bits; no
    library sort). Equal to ``bag_grouping_ref``'s in the entries it uses.
    No ids launch no kernel (two memsets) and count no launch. Meta ids:
    the plan's buffers at their bound, the cost, no launch."""
    if not card_or_meta(ids):
        raise ValueError("bag_grouping_cuda: ids must be on CUDA (or meta)")
    if ids.dtype != torch.int32:
        raise TypeError("bag_grouping_cuda: ids must be int32")
    if num_rows <= 0:
        raise ValueError(f"bag_grouping_cuda: num_rows must be positive, "
                         f"got {num_rows}")
    flat = ids.reshape(-1).contiguous()
    n = flat.numel()
    if n >= 1 << 29:
        raise ValueError(f"bag_grouping_cuda: {n} ids; at most 2^29 - 1")
    cap = min(n, num_rows)
    meta = flat.is_meta
    lib = None if meta else cuda_lib.library()
    words = grouping_scratch_words(n) if meta else \
        lib.bag_grouping_scratch_words(n)
    # one allocation: order (n), rows (cap), starts (cap + 1), count (2),
    # then the kernel's scratch
    buf = torch.empty((n + 2 * cap + 3 + words,), dtype=torch.int32,
                      device=flat.device)
    order, rows, starts, count, scratch = buf.split(
        [n, cap, cap + 1, 2, buf.numel() - n - 2 * cap - 3])
    plan = BagPlan(ids=flat, num_rows=num_rows, order=order, rows=rows,
                   starts=starts, count=count)
    if n:
        record_kernel("bag_grouping", *grouping_cost(n, num_rows))
    if meta:
        return plan
    code = lib.bag_grouping(
        flat.data_ptr(), order.data_ptr(), rows.data_ptr(),
        starts.data_ptr(), count.data_ptr(), scratch.data_ptr(), n,
        num_rows, torch.cuda.current_stream(flat.device).cuda_stream)
    cuda_lib.check(code, "bag_grouping")
    if n:
        bag_grouping_cuda.launches += 1
    return plan


bag_grouping_cuda.launches = 0


def check_plan(plan: BagPlan, ids: torch.Tensor, num_rows: int,
               name: str) -> None:
    """Raise unless ``plan`` groups as many ids as ``ids`` holds, over
    ``num_rows`` rows, on ``ids``' device."""
    if plan.num_rows != num_rows or plan.ids.numel() != ids.numel() or \
            plan.order.device != ids.device:
        raise ValueError(f"{name}: the plan groups {plan.ids.numel()} ids "
                         f"over {plan.num_rows} rows on {plan.order.device}"
                         f", not {ids.numel()} over {num_rows} on "
                         f"{ids.device}")


def embedding_bag_backward_cuda(grad_out: torch.Tensor, ids: torch.Tensor,
                                weights: Optional[torch.Tensor],
                                combiner: str, out: torch.Tensor,
                                plan: Optional[BagPlan] = None,
                                store: bool = False) -> torch.Tensor:
    """Add the bag's gradient with respect to the table into ``out``:
    out[ids[b, l]] += (grad_out[b] / denom_b) * weights[b, l] for every
    ids[b, l] >= 0 (denom_b = max(sum_l weights[b, l], 1e-9) under mean, 1
    under sum). grad_out (B, D) f32, ids (B, L) int32, weights (B, L) f32
    or None, out (V, D) f32; returns ``out``. Each row's terms are summed
    in ascending (b, l) order from +0.0 and added to it once, one warp a
    row. ``plan``: ``bag_grouping_cuda(ids, V)``, built here (one grouping
    launch) when None. ``store``: ``out`` is fresh zeros, so each touched
    row is written with its sum and not read (the same bits). Meta
    operands: the cost, no launch."""
    _check_operands(out, ids, weights, combiner)
    if out.dtype != torch.float32:
        raise TypeError(f"embedding_bag_backward_cuda: the gradient must be "
                        f"float32, got {out.dtype}")
    b, bag_len = ids.shape
    v, d = out.shape
    if grad_out.shape != (b, d) or grad_out.dtype != torch.float32 or \
            grad_out.device != out.device or not grad_out.is_contiguous():
        raise ValueError(f"embedding_bag_backward_cuda: grad_out must be a "
                         f"contiguous float32 ({b}, {d}) tensor on "
                         f"{out.device}, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    if plan is None:
        plan = bag_grouping_cuda(ids, v)
    else:
        check_plan(plan, ids, v, "embedding_bag_backward_cuda")
    mean = combiner == "mean"
    denom = torch.empty((b,), dtype=torch.float32, device=out.device) \
        if mean else None
    record_kernel("embedding_bag_backward", *backward_cost(
        b, bag_len, d, v, weights is not None, store))
    if out.is_meta:
        return out
    vec4 = d % 4 == 0 and out.data_ptr() % 16 == 0 and \
        grad_out.data_ptr() % 16 == 0
    lib = cuda_lib.library()
    code = lib.embedding_bag_backward(
        grad_out.data_ptr(), ids.data_ptr(), plan.order.data_ptr(),
        plan.rows.data_ptr(), plan.starts.data_ptr(), plan.count.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if denom is None else denom.data_ptr(),
        out.data_ptr(), b, bag_len, v, d, plan.rows.numel(), int(mean),
        int(vec4), int(store),
        torch.cuda.current_stream(out.device).cuda_stream)
    cuda_lib.check(code, "embedding_bag_backward")
    embedding_bag_backward_cuda.launches += 1
    return out


embedding_bag_backward_cuda.launches = 0
