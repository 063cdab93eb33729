"""Plain PyTorch version: gather rows, squared L2 against each query
(the diff-square form of the reference's ``gather_dist/ref.py``), and the
sharded tier's modes: bf16 rows and the prenorm distance.

f32 rows without norms take the reference's form, one ``sum`` over the
differences squared. The modes (a bf16 ``db``, or ``norms`` given) follow
the kernel's order instead (``lanes_reduce``): lane ``l`` of a warp sums
the 4-element chunks ``l, l + 32, ...`` of the row with a fused
multiply-add per element, and the 32 lanes combine by the xor tree of
``common.cuh``. Each fused multiply-add is rounded once, as the card does
(``fma32``), so on the card kernel and plain version agree bit for bit in
every mode, on any data.
"""
from typing import Optional

import torch

LANES = 32
CHUNK = 4


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once to nearest, as ``__fmaf_rn``.

    The product is exact in f64; the sum is taken in f64, its rounding
    error recovered (TwoSum), and the f64 result rounded to odd, from which
    rounding to f32 gives the correctly rounded f32 sum (f64 has more than
    two bits over f32's 24)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def lanes_reduce(q: torch.Tensor, rows: torch.Tensor,
                 dot: bool = False) -> torch.Tensor:
    """(B, D), (B, R, D) f32 -> (B, R): sum of (q - x)^2 (``dot``: of
    q * x) in ``common.cuh``'s row_sqdist order, bit for bit."""
    b, r, d = rows.shape
    n_chunks = -(-d // CHUNK)
    kk = -(-n_chunks // LANES)
    lanes = min(LANES, n_chunks)
    width = kk * LANES * CHUNK
    qv = torch.nn.functional.pad(q.float(), (0, width - d)).view(
        b, 1, kk, LANES, CHUNK)[:, :, :, :lanes]
    xv = torch.nn.functional.pad(rows.float(), (0, width - d)).view(
        b, r, kk, LANES, CHUNK)[:, :, :, :lanes]
    acc = torch.zeros((b, r, lanes), dtype=torch.float32, device=rows.device)
    for k in range(kk):
        for j in range(CHUNK):
            a, x = qv[:, :, k, :, j], xv[:, :, k, :, j]
            if dot:
                acc = fma32(a.expand_as(x), x, acc)
            else:
                t = a - x
                acc = fma32(t, t, acc)
    acc = torch.nn.functional.pad(acc, (0, LANES - lanes))
    off = LANES // 2
    while off:
        acc = acc[..., :off] + acc[..., off:2 * off]
        off //= 2
    return acc[..., 0]


def prenorm_dist(qn, norms, dot):
    """max((|q|^2 + |x|^2) - 2 q.x, 0), each step rounded in f32."""
    return ((qn + norms) - 2.0 * dot).clamp_min(0.0)


def gather_dist_ref(queries: torch.Tensor, db: torch.Tensor,
                    ids: torch.Tensor,
                    norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    safe = ids.clamp_min(0).long()
    rows = db[safe].float()                                  # (B, R, D)
    if norms is None and db.dtype == torch.float32:
        d = ((rows - queries.float()[:, None, :]) ** 2).sum(-1)
    elif norms is None:
        d = lanes_reduce(queries, rows)
    else:
        q = queries.float()
        qn = lanes_reduce(q, q[:, None, :], dot=True)        # (B, 1)
        d = prenorm_dist(qn, norms[safe], lanes_reduce(q, rows, dot=True))
    return torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
