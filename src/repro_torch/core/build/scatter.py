"""Deterministic stand-ins for the reference's ordered scatters and its
uint32 slot hashes, shared by NN-Descent, the table pools and the device
finishing pass.

The reference writes fixed-shape slot buffers with ``.at[].set`` (the last
of several writers to one cell wins: XLA on the CPU applies duplicate
updates in order; out-of-range rows are dropped) and hashes ids to slots in
uint32 arithmetic. torch's ``index_put_`` names no winner among duplicates
on CUDA, raises on an out-of-range row and lacks full uint32 arithmetic on
CUDA, so:

  * ``last_writer`` takes the largest flat update position per cell — the
    last writer in the reference's order — and the caller gathers the
    value written through it;
  * ``nearest_last_writer`` is the reference's scatter-min followed by its
    winner re-scatter (the least value per cell, the last writer among
    equals);
  * both are one stable sort of the cells, with no atomics: many updates
    to one cell (a hub's slots in NN-Descent's proposal buffer and reverse
    samples) serialize CUDA's ``scatter_reduce("amin" / "amax")``, which
    retries a compare-and-swap per contender (99 ms for one reverse
    sample of 6M edges into 300k x 5 slots on an H100, against a sort's
    few);
  * dropped updates go to a spare row ``n`` that the caller slices off;
  * ``hash_slot`` computes the uint32 product in int64, split in 16-bit
    halves so that no intermediate leaves the int64 range, and masks it
    to 32 bits.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
KNUTH = 2654435761           # the reference's multiplicative hash constant


def hash_slot(val: torch.Tensor, slots: int, salt: int = 0) -> torch.Tensor:
    """((uint32(val) ^ uint32(salt)) * 2654435761) % slots, as int64.

    ``val`` may hold -1 (uint32 0xFFFFFFFF, as the reference's cast gives).
    The product mod 2**32 is the low 16 bits of the constant times h plus
    its high 16 bits times h, cut to 16 bits before the shift: no
    intermediate reaches 2**49.
    """
    h = (val.to(torch.int64) & _U32) ^ (int(salt) & _U32)
    lo = h * (KNUTH & 0xFFFF)
    hi = (h * (KNUTH >> 16)) & 0xFFFF
    return ((lo + (hi << 16)) & _U32) % slots


def last_writer(index: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) int64: per cell, the largest position p with ``index[p]`` ==
    cell (the last of the updates in flat order), -1 where none wrote.

    One stable sort of the cells: the last entry of each run holds the
    largest position, and only those write (the rest go to a spare cell
    past ``size``), so no atomics contend on a cell many updates hit."""
    idx = index.reshape(-1).to(torch.int64)
    srt, order = torch.sort(idx, stable=True)
    last = torch.ones_like(srt, dtype=torch.bool)
    last[:-1] = srt[1:] != srt[:-1]
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=idx.device)
    out[torch.where(last, srt, size)] = torch.where(last, order, -1)
    return out[:size]


def scatter_min(index: torch.Tensor, src: torch.Tensor, size: int,
                fill) -> torch.Tensor:
    """(size,) per-cell minimum of ``src`` over the updates to that cell,
    ``fill`` where none wrote (the reference's ``.at[].min`` into a buffer
    filled with ``fill``)."""
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    return out.scatter_reduce_(0, index.reshape(-1).to(torch.int64),
                               src.reshape(-1), "amin", include_self=True)


def nearest_last_writer(cell: torch.Tensor, d: torch.Tensor):
    """Per cell, the update with the least ``d`` and, among equal ``d``,
    the last in flat order.

    ``d`` holds non-negative f32 values or +inf, whose bit patterns order
    as the values do (-0.0 is taken as +0.0); cells are below 2**32.
    Returns (pos, first): the flat positions sorted by (cell, d, position
    descending), and a mask of the first entry of each cell's run — the
    winner. One stable sort of (cell, bits of d) keys over the updates
    taken in reverse order.
    """
    m = cell.numel()
    bits = (d.reshape(-1) + 0.0).view(torch.int32).to(torch.int64)
    key = (cell.reshape(-1).to(torch.int64) << 31) | bits
    order = torch.sort(torch.flip(key, [0]), stable=True).indices
    pos = (m - 1) - order
    c = cell.reshape(-1)[pos]
    first = torch.ones(m, dtype=torch.bool, device=cell.device)
    first[1:] = c[1:] != c[:-1]
    return pos, first
