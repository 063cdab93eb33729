"""Per-hop HBM traffic of the port's two beam-search hops on an H100 (the
reference's ``analysis/hop_traffic.py``, re-derived for the card).

Each hop of one active query moves

  * **compulsory** bytes, which any implementation moves: the R candidate
    rows (f32 vectors, or uint8 code rows under pq / int8), the adjacency
    row of the frontier node, and the per-query score operand (the query,
    or the (M, C) ADC LUT). The same formula as the reference's
    ``_compulsory``, for both hops.

  * **spilled** bytes, hot state that round-trips through device memory.

The port's **staged** hop (``core/beam_search.py`` ``_expand_batch``: the
gather and distance, then ``merge_one``, each a separate op) spills what
the reference's staged ops spill, per hop:

  * pool state read + write                        2 * ef * 9
  * merge concat block written then re-read        2 * (ef + R) * 9
  * stable-argsort permutation written + read      2 * (ef + R) * 4
  * candidate ids: gather out, distance in,
    merge in                                       3 * R * 4
  * candidate distances: distance out, merge in    2 * R * 4
  * selected frontier id + active flag             8

(a pool slot is 9 bytes: an i32 id, an f32 distance, a bool visited flag).

The port's **fused** loop (``csrc/beam_hop.cu``, ``beam_hops``: every hop
of a search in one launch) keeps the pool in two shared-memory buffers
and stages the query once per search, so its spill is per search, not per
hop:

  * pool read once at entry and written once at exit   2 * ef * 9
  * the lane's counters: hops, gathered, dup, stale
    read; those, the iteration count and the live
    flag written                                       4 * 4 + 5 * 4 + 1

Its spill per hop is that over the search's hops, and falls as the hops
grow. ``fused_loop_bytes`` prices a whole launch as the card reads it:
each candidate row and adjacency row rounded up to whole 32-byte sectors
(a 600-d f32 row is 75 sectors exactly; a 600-d bf16 row, 1,200 bytes,
takes 38 = 1,216 bytes; a 32-entry adjacency row 4), the operand once per
lane; it is the ``beam_hops`` kernel's cost record.
"""
from __future__ import annotations

from dataclasses import dataclass

# Pool slot: id (i32) + distance (f32) + visited flag (bool) per lane.
POOL_SLOT_BYTES = 9
SECTOR = 32
_I32 = 4
_F32 = 4
COUNTER_BYTES = 4 * _I32 + 5 * _I32 + 1     # fused loop, per lane a search


def sectors(nbytes: int) -> int:
    """Bytes of the whole 32-byte sectors that hold ``nbytes``."""
    return -(-nbytes // SECTOR) * SECTOR


@dataclass(frozen=True)
class HopTraffic:
    """Bytes moved through device memory for ONE hop of ONE active
    query."""
    compulsory: float
    spilled: float

    @property
    def total(self) -> float:
        return self.compulsory + self.spilled


def _code_width(dim: int, pq_m: int) -> int:
    return pq_m if pq_m else max(1, dim // 2)


def _compulsory(r: int, dim: int, dist_backend: str, pq_m: int,
                pq_c: int) -> int:
    if dist_backend == "f32":
        rows = r * dim * _F32            # R database vectors
        operand = dim * _F32             # the query vector
    else:
        m = _code_width(dim, pq_m)
        rows = r * m                     # R uint8 code rows
        operand = m * pq_c * _F32        # the per-query ADC LUT
    graph_row = r * _I32                 # the adjacency row of the frontier
    return rows + graph_row + operand


def staged_hop_traffic(ef: int, r: int, dim: int,
                       dist_backend: str = "f32", pq_m: int = 0,
                       pq_c: int = 256) -> HopTraffic:
    """The staged hop: gather + distance, then the merge, each through
    device memory (inventory in the module docstring)."""
    spilled = (2 * ef * POOL_SLOT_BYTES
               + 2 * (ef + r) * POOL_SLOT_BYTES
               + 2 * (ef + r) * _I32
               + 3 * r * _I32
               + 2 * r * _F32
               + 8)
    return HopTraffic(_compulsory(r, dim, dist_backend, pq_m, pq_c), spilled)


def fused_search_spill(ef: int) -> int:
    """The fused loop's spill for one lane's whole search."""
    return 2 * ef * POOL_SLOT_BYTES + COUNTER_BYTES


def fused_hop_traffic(ef: int, r: int, dim: int,
                      dist_backend: str = "f32", pq_m: int = 0,
                      pq_c: int = 256, hops: int = 1) -> HopTraffic:
    """The fused loop, per hop of a search of ``hops`` hops: the
    compulsory bytes, and the per-search spill over the hops."""
    return HopTraffic(_compulsory(r, dim, dist_backend, pq_m, pq_c),
                      fused_search_spill(ef) / max(hops, 1))


def fused_loop_bytes(lanes: int, steps: int, ef: int, r: int, dim: int,
                     dist_backend: str = "f32", pq_m: int = 0,
                     pq_c: int = 256, row_bytes: int = _F32,
                     prenorm: bool = False) -> int:
    """Device-memory bytes of one ``beam_hops`` launch of ``lanes`` lanes
    running ``steps`` hops each: per hop R sector-rounded candidate rows
    (``row_bytes`` per element: 4 for f32, 2 for bf16; codes are bytes)
    and the adjacency row (plus R norms under prenorm); per lane the
    operand once and ``fused_search_spill``."""
    if dist_backend == "f32":
        rows = r * sectors(dim * row_bytes)
        operand = dim * _F32
    else:
        m = _code_width(dim, pq_m)
        rows = r * sectors(m)
        operand = m * pq_c * _F32
    per_hop = rows + sectors(r * _I32) + (sectors(r * _F32) if prenorm
                                          else 0)
    return lanes * (steps * per_hop + operand + fused_search_spill(ef))


def hop_traffic_report(ef: int, r: int, dim: int,
                       dist_backend: str = "f32", pq_m: int = 0,
                       pq_c: int = 256, hops: int = 1) -> dict:
    """Both hops priced at one config (the fused spill over ``hops`` hops
    of a search). ``spill_reduction`` is staged spilled / fused spilled;
    ``total_reduction`` includes the compulsory floor both share."""
    st = staged_hop_traffic(ef, r, dim, dist_backend, pq_m, pq_c)
    fu = fused_hop_traffic(ef, r, dim, dist_backend, pq_m, pq_c, hops)
    return {
        "ef": ef, "r": r, "dim": dim, "dist_backend": dist_backend,
        "hops": hops,
        "compulsory_bytes_per_hop": st.compulsory,
        "staged_spilled_bytes_per_hop": st.spilled,
        "fused_spilled_bytes_per_hop": fu.spilled,
        "staged_total_bytes_per_hop": st.total,
        "fused_total_bytes_per_hop": fu.total,
        "spill_reduction_vs_staged": round(st.spilled / fu.spilled, 3),
        "total_reduction_vs_staged": round(st.total / fu.total, 3),
    }


def traversal_savings_report(stats: dict, ef: int, r: int, dim: int,
                             dist_backend: str = "f32", pq_m: int = 0,
                             pq_c: int = 256, hop_backend: str = "staged",
                             baseline_stats: dict = None) -> dict:
    """Price a traversal's straggler waste in modeled device-memory bytes.

    ``stats``: a ``search_stats()`` dict. ``hops`` hops did real work;
    ``wasted_hops`` are lock-stepped hops of lanes that had already
    converged, each billed a full hop. ``hop_backend``: "staged" or
    "fused" (its per-search spill spread over the hops a lane sat
    through: ``mean_hops`` scaled by launched / useful). ``baseline_stats``:
    a ``patience=None`` run's stats, for the cross-run ratios.
    """
    if hop_backend not in ("staged", "fused"):
        raise ValueError(f"hop_backend must be 'staged' or 'fused', got "
                         f"{hop_backend!r}")
    useful = int(stats["hops"])
    wasted = int(stats["wasted_hops"])
    launched = useful + wasted
    if hop_backend == "fused":
        per_lane = float(stats.get("mean_hops", 1.0)) * launched / max(
            useful, 1)
        traffic = fused_hop_traffic(ef, r, dim, dist_backend, pq_m, pq_c,
                                    max(int(round(per_lane)), 1))
    else:
        traffic = staged_hop_traffic(ef, r, dim, dist_backend, pq_m, pq_c)
    report = {
        "ef": ef, "r": r, "dim": dim, "dist_backend": dist_backend,
        "hop_backend": hop_backend,
        "bytes_per_hop": traffic.total,
        "useful_hops": useful,
        "wasted_hops": wasted,
        "launched_hops": launched,
        "active_fraction": round(useful / max(launched, 1), 4),
        "useful_bytes": useful * traffic.total,
        "wasted_bytes": wasted * traffic.total,
    }
    if baseline_stats is not None:
        base_useful = int(baseline_stats["hops"])
        base_launched = base_useful + int(baseline_stats["wasted_hops"])
        report["baseline_useful_hops"] = base_useful
        report["baseline_launched_hops"] = base_launched
        report["hop_reduction_vs_baseline"] = round(
            base_useful / max(useful, 1), 3)
        report["launched_reduction_vs_baseline"] = round(
            base_launched / max(launched, 1), 3)
        report["bytes_saved_vs_baseline"] = (
            (base_launched - launched) * traffic.total)
    return report
