"""Launch wrapper of the CUDA ``alpha_scan`` kernels (``csrc/alpha_scan.cu``):
one chunk's whole greedy α-RNG occlusion scan in one launch.

Two variants compute the same function; ``route`` picks one by shape and
each counts its own launches in ``alpha_scan_cuda.by_variant``
(``alpha_scan_cuda.launches`` is their sum):

- ``staged``: one warp per row, each candidate's row loaded while the one
  before it is tested, the first ``staged_slots`` kept rows in the warp's
  shared memory (float4 rows of D <= 1024 whose ``staged_slots`` is not
  0).
- ``warp``: one warp per row, the candidate and kept rows read through the
  L2 as each test needs them, for the rest (any D, degree up to
  ``MAX_DEGREE``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.gather_dist.gather_dist import vec4_ok

# warp: kept ids live in shared memory, one (degree,) list per warp of a
# block (csrc kScanWarps = 4): 2048 ids keep a block at 32 KB
MAX_DEGREE = 2048
VARIANTS = ("warp", "staged")       # the C entry point's variant codes
# staged: csrc kStagedWarps (rows per block, a warp each) and
# kStagedWarpsPerSm (the occupancy its kept-row slots are sized for); float4
# rows of at most 4 * 32 * 8 floats
STAGED_WARPS, STAGED_WARPS_PER_SM, STAGED_MAX_D = 4, 12, 1024


def staged_warp_bytes(degree: int, l: int, d: int, slots: int) -> int:
    """Shared memory of one warp of a staged block with ``slots`` kept-row
    slots (csrc ``staged_warp_bytes``): the slots, the live candidates'
    ids, positions and thresholds, the kept ids and their candidate
    indices; 16-byte aligned."""
    bytes_ = slots * d * 4 + 3 * l * 4 + 2 * degree * 4
    return -(-bytes_ // 16) * 16


def staged_slots(degree: int, l: int, d: int, per_sm: int = 233_472,
                 reserved: int = 1024) -> int:
    """The staged kernel's kept-row slots per warp (csrc ``staged_slots``):
    the most, up to ``degree``, that let STAGED_WARPS_PER_SM warps share an
    SM (``per_sm`` bytes of shared memory, ``reserved`` of them kept back
    per block: an H100's); 0 if not one fits beside the warp's lists."""
    per_block = per_sm // (STAGED_WARPS_PER_SM // STAGED_WARPS) - reserved
    for s in range(degree, 0, -1):
        if STAGED_WARPS * staged_warp_bytes(degree, l, d, s) <= per_block:
            return s
    return 0


def route(degree: int, l: int, d: int, aligned: bool = True,
          variant: Optional[str] = None) -> str:
    """The variant a scan of ``degree`` kept rows over pools of ``l`` takes
    on rows of ``d`` floats (``aligned``: 16-byte aligned rows). ``variant``
    forces one; it must take the shape."""
    staged = (aligned and d % 4 == 0 and d <= STAGED_MAX_D
              and staged_slots(degree, l, d) > 0)
    if variant is None:
        return "staged" if staged else "warp"
    if variant not in VARIANTS:
        raise ValueError(f"alpha_scan_cuda: unknown variant {variant!r}; "
                         f"expected one of {VARIANTS}")
    if variant == "staged" and not staged:
        raise ValueError(
            f"alpha_scan_cuda: the staged variant takes float4 rows of D <= "
            f"{STAGED_MAX_D} whose lists leave a kept-row slot per warp at "
            f"{STAGED_WARPS_PER_SM} warps per SM; got degree={degree}, L={l}, "
            f"D={d}, aligned={aligned}")
    return variant


def _check_operands(data, node_ids, cand_ids, cand_dists, degree, alpha):
    tensors = [("data", data), ("node_ids", node_ids),
               ("cand_ids", cand_ids), ("cand_dists", cand_dists)]
    if isinstance(alpha, torch.Tensor):
        tensors.append(("alpha", alpha))
    if not all(t.is_cuda for _, t in tensors):
        raise ValueError("alpha_scan_cuda: every operand must be on CUDA")
    if any(t.device != data.device for _, t in tensors):
        raise ValueError("alpha_scan_cuda: operands on different devices")
    if data.dtype != torch.float32 or cand_dists.dtype != torch.float32:
        raise TypeError("alpha_scan_cuda: data and cand_dists must be "
                        "float32")
    if node_ids.dtype != torch.int32 or cand_ids.dtype != torch.int32:
        raise TypeError("alpha_scan_cuda: node_ids and cand_ids must be "
                        "int32")
    if data.dim() != 2 or node_ids.dim() != 1 or cand_ids.dim() != 2:
        raise ValueError("alpha_scan_cuda: expected (N, D), (B,), (B, L), "
                         "(B, L)")
    b, l = cand_ids.shape
    if cand_dists.shape != cand_ids.shape or node_ids.shape[0] != b:
        raise ValueError(f"alpha_scan_cuda: shapes {tuple(node_ids.shape)},"
                         f" {tuple(cand_ids.shape)}, "
                         f"{tuple(cand_dists.shape)} disagree")
    if data.shape[0] == 0:
        raise ValueError("alpha_scan_cuda: empty data")
    if not 1 <= degree <= min(l, MAX_DEGREE):
        raise ValueError(f"alpha_scan_cuda: degree {degree} outside "
                         f"[1, min(L = {l}, {MAX_DEGREE})]")
    if isinstance(alpha, torch.Tensor) and (
            alpha.dtype != torch.float32 or alpha.shape != (b,)):
        raise ValueError(f"alpha_scan_cuda: a tensor alpha must be ({b},) "
                         f"float32, got {tuple(alpha.shape)} {alpha.dtype}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"alpha_scan_cuda: {name} is not contiguous")


def alpha_scan_cuda(data: torch.Tensor, node_ids: torch.Tensor,
                    cand_ids: torch.Tensor, cand_dists: torch.Tensor,
                    degree: int, alpha: Union[float, torch.Tensor],
                    variant: Optional[str] = None):
    """data (N, D) f32, node_ids (B,) int32, cand_ids (B, L) int32,
    cand_dists (B, L) f32, alpha a float or a (B,) f32 tensor -> (keep
    (B, degree) int32, mask (B, L) bool), as ``ref.alpha_scan_ref``. The
    variant is ``route``'s unless one is forced."""
    _check_operands(data, node_ids, cand_ids, cand_dists, degree, alpha)
    b, l = cand_ids.shape
    n, d = data.shape
    aligned = vec4_ok(d, data)
    variant = route(degree, l, d, aligned, variant)
    dev = data.device
    keep = torch.empty((b, degree), dtype=torch.int32, device=dev)
    mask = torch.empty((b, l), dtype=torch.bool, device=dev)
    if b == 0:
        return keep, mask
    rows = alpha if isinstance(alpha, torch.Tensor) else None
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.alpha_scan_f32(
        data.data_ptr(), node_ids.data_ptr(), cand_ids.data_ptr(),
        cand_dists.data_ptr(), None if rows is None else rows.data_ptr(),
        0.0 if rows is not None else float(alpha), keep.data_ptr(),
        mask.data_ptr(), b, l, degree, n, d, int(aligned),
        VARIANTS.index(variant), stream)
    cuda_lib.check(code, f"alpha_scan_f32 ({variant})")
    alpha_scan_cuda.launches += 1
    alpha_scan_cuda.by_variant[variant] += 1
    return keep, mask


def reset_launches() -> None:
    """Zero the total and every variant's launch count."""
    alpha_scan_cuda.launches = 0
    alpha_scan_cuda.by_variant = dict.fromkeys(VARIANTS, 0)


reset_launches()
