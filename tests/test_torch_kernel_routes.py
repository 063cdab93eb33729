"""The launch routes of the ``topk_merge``, ``lut_dist``, ``l2topk`` (its
k limits) and ``alpha_scan`` wrappers.

``route`` is plain arithmetic over the shape, so it is held here: the
variant each main-path shape takes, each boundary, and the forced variants
that must be refused. The kernels it picks run only on the card
(``tests/test_torch_cuda.py``, ``-k topk``, ``-k lut_dist``, ``-k l2topk``
and ``-k alpha_scan``). On the CPU the dispatchers run the plain versions
and count no launch.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.alpha_scan import alpha_scan, alpha_scan_cuda, \
    alpha_scan_ref
from repro_torch.kernels.alpha_scan.alpha_scan import (
    MAX_DEGREE, STAGED_WARPS, STAGED_WARPS_PER_SM, VARIANTS as SCAN_VARIANTS,
    route as scan_route, staged_slots, staged_warp_bytes,
)
from repro_torch.kernels.l2topk.l2topk import (
    MAX_K, TC_MAX_K, route as l2topk_route,
)
from repro_torch.kernels.lut_dist import lut_dist, lut_dist_cuda
from repro_torch.kernels.lut_dist.lut_dist import (
    VARIANTS as LUT_VARIANTS, WARP_MAX_PAIRS, route as lut_route,
)
from repro_torch.kernels.topk_merge import (
    topk_merge, topk_merge_cuda, topk_merge_ref, topk_pool, topk_pool_ref,
)
from repro_torch.kernels.topk_merge.topk_merge import (
    MAX_SORT, VARIANTS as TOPK_VARIANTS, WARP_MAX_SORT, route as topk_route,
)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

# (name, M) -> variant: the topk_merge calls of the main path and of the
# next two slices at ann-laion's widths (degree 32, candidates 64)
TOPK_CASES = [
    ("nsg_pool_assembly", 64 + 32, "warp"),        # ef pool + own kNN list
    ("device_finish_union", 32 + 2 * 32, "warp"),  # R + rev_cap
    ("nn_descent_merge", 32 + 20 + 64, "warp"),    # kk + (mc - 1) + u_slots
    # the default fit's NN-Descent merges (merge mode, table width kk plus
    # its candidates): the random-projection joins (bsize 32) of the
    # AntiHub table (kk 20) and the structural one (kk 32), the subset
    # seed (10 raw neighbours) and the AntiHub table's rounds (20 direct
    # + u_slots 40)
    ("rp_join_knn", 32 + 32, "warp"),
    ("rp_join_antihub", 20 + 32, "warp"),
    ("subset_seed", 32 + 10, "warp"),
    ("nn_descent_merge_antihub", 20 + 20 + 40, "warp"),
    # the table pools (pool mode): 32 forward + 32 reverse + 32 x 4 hops
    ("table_pools", 32 + 32 + 32 * 4, "warp"),
    ("one", 1, "warp"),
    ("p32", 32, "warp"),
    ("p256", 256, "warp"),
    ("p512", 257, "block"),
    ("p2048", 2048, "block"),
]


@pytest.mark.parametrize("name,m,variant", TOPK_CASES,
                         ids=[c[0] for c in TOPK_CASES])
def test_topk_route_table(name, m, variant):
    assert topk_route(m) == variant


@pytest.mark.parametrize("m", [1, 31, 32, 33, 200, 256, 257, 1000, 2048])
@pytest.mark.parametrize("variant", TOPK_VARIANTS)
def test_topk_forced_variant_takes_its_widths(variant, m):
    if variant == "warp" and m > WARP_MAX_SORT:
        with pytest.raises(ValueError, match="warp variant"):
            topk_route(m, variant)
    else:
        assert topk_route(m, variant) == variant


@pytest.mark.parametrize("variant", [None, "block", "warp"])
def test_topk_route_refuses_rows_past_the_sort(variant):
    with pytest.raises(ValueError, match="exceeds"):
        topk_route(MAX_SORT + 1, variant)


def test_topk_route_refuses_unknown_variants():
    with pytest.raises(ValueError, match="unknown variant"):
        topk_route(96, "thread")


def test_topk_warp_width_is_the_kernels():
    """The route's warp limit is the one the C entry point enforces."""
    src = (CSRC / "topk_merge.cu").read_text()
    assert re.search(r"kWarpMaxSort = (\d+);", src).group(1) == \
        str(WARP_MAX_SORT)


# pairs -> variant: the pool seed (Q x 1), the staged hop (Q x R), the
# crossover's two sides
LUT_CASES = [
    ("pool_seed", 1024 * 1, "warp"),
    ("staged_hop", 1024 * 32, "thread"),
    ("one_pair", 1, "warp"),
    ("crossover", WARP_MAX_PAIRS, "warp"),
    ("past_crossover", WARP_MAX_PAIRS + 1, "thread"),
]


@pytest.mark.parametrize("name,pairs,variant", LUT_CASES,
                         ids=[c[0] for c in LUT_CASES])
def test_lut_route_table(name, pairs, variant):
    assert lut_route(pairs) == variant


@pytest.mark.parametrize("pairs", [0, 1, 1024, 32768, 10 ** 7])
@pytest.mark.parametrize("variant", LUT_VARIANTS)
def test_lut_forced_variant_takes_every_shape(variant, pairs):
    assert lut_route(pairs, variant) == variant


def test_lut_route_refuses_unknown_variants():
    with pytest.raises(ValueError, match="unknown variant"):
        lut_route(1024, "block")


def test_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers take CUDA tensors only."""
    ids = torch.zeros((2, 40), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        topk_merge_cuda(ids, torch.zeros((2, 40)), None, 4, merge=False,
                        variant="warp")
    with pytest.raises(ValueError):
        lut_dist_cuda(torch.zeros((2, 3, 4)),
                      torch.zeros((5, 3), dtype=torch.uint8),
                      torch.zeros((2, 1), dtype=torch.int32),
                      variant="warp")


def test_cpu_dispatch_runs_the_plain_versions_and_counts_nothing():
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(-1, 30, (9, 96)).astype(np.int32))
    ds = torch.from_numpy(rng.integers(0, 5, (9, 96)).astype(np.float32))
    fresh = torch.from_numpy(rng.random((9, 32)) < 0.5)
    lut = torch.from_numpy(rng.random((9, 7, 16)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (40, 7)).astype(np.uint8))
    rows = torch.from_numpy(rng.integers(-1, 40, (9, 1)).astype(np.int32))
    before = (topk_merge_cuda.launches, dict(topk_merge_cuda.by_variant),
              lut_dist_cuda.launches, dict(lut_dist_cuda.by_variant))
    for a, b in zip(topk_pool(ids, ds, 64), topk_pool_ref(ids, ds, 64)):
        assert torch.equal(a, b)
    merged = (ids[:, :32], ds[:, :32], fresh, ids[:, 32:], ds[:, 32:], 32)
    for a, b in zip(topk_merge(*merged), topk_merge_ref(*merged)):
        assert torch.equal(a, b)
    got = lut_dist(lut, codes, rows)
    assert torch.equal(torch.isinf(got), rows < 0)
    assert (topk_merge_cuda.launches, topk_merge_cuda.by_variant,
            lut_dist_cuda.launches, lut_dist_cuda.by_variant) == before


# (Q, N, D, k) -> variant: the l2topk k limits. k = 128 is the tile
# variant's last width, 129 and 1000 take wide (FlatIndex's and an exact
# kNN table's wide k), k over N is cut to N first
L2TOPK_K_CASES = [
    ("k128", (1024, 300_000, 768, 128), "tile"),
    ("k129", (1024, 300_000, 768, 129), "wide"),
    ("k1000", (1024, 300_000, 768, 1000), "wide"),
    ("k256_flat", (1024, 300_000, 768, 256), "wide"),
    ("k_n", (40, 900, 16, 900), "wide"),
    ("medoid_k1000", (1, 270_000, 600, 1000), "wide"),
]


@pytest.mark.parametrize("name,shape,variant", L2TOPK_K_CASES,
                         ids=[c[0] for c in L2TOPK_K_CASES])
def test_l2topk_route_by_k(name, shape, variant):
    q, n, d, k = shape
    plan = l2topk_route(q, n, d, k, 132)
    assert plan.variant == variant
    n_tiles = -(-n // 128)
    assert plan.splits >= 1
    assert (plan.splits - 1) * plan.tiles_per_split < n_tiles \
        <= plan.splits * plan.tiles_per_split
    if variant == "wide":      # each split's k-key list over >= ~k rows
        assert plan.splits <= max(1, n // k)


@pytest.mark.parametrize("k", [1, 64, 128, 129, 5000])
def test_l2topk_forced_wide_takes_every_k(k):
    assert l2topk_route(500, 6000, 64, k, 132, "wide").variant == "wide"


def test_l2topk_forced_variants_refuse_wide_k():
    with pytest.raises(ValueError, match="tc variant"):
        l2topk_route(1024, 300_000, 768, TC_MAX_K + 1, 132, "tc")
    with pytest.raises(ValueError, match="tile variant"):
        l2topk_route(1024, 300_000, 768, MAX_K + 1, 132, "tile")
    with pytest.raises(ValueError, match="small variant"):
        l2topk_route(100, 256, 2, 129, 132, "small")
    assert l2topk_route(1024, 300_000, 768, MAX_K, 132, "tile").variant \
        == "tile"


def test_l2topk_limits_are_the_kernels():
    """The route's tile limit is the one the C entry point enforces."""
    src = (CSRC / "l2topk.cu").read_text()
    assert re.search(r"kMaxK = (\d+);", src).group(1) == str(MAX_K)
    assert re.search(r"kTcMaxK = (\d+);", src).group(1) == str(TC_MAX_K)


# (degree, L, D) -> variant: the α-scan's three path shapes (ann-laion:
# degree 32, D = 600) take staged; rows that are not float4 or wider than
# 1024 floats, and lists that leave no kept-row slot per warp at 12 warps
# per SM (degree 2048), take warp. A degree past the slots still takes
# staged: its later kept rows are read through the L2
SCAN_CASES = [
    ("prune", (32, 64, 600), "staged"),
    ("interconnect", (32, 96, 600), "staged"),
    ("reprune_family", (32, 32, 600), "staged"),
    ("recsys_ann", (16, 48, 256), "staged"),
    ("widest_staged_rows", (32, 64, 1024), "staged"),
    ("degree_past_the_slots", (96, 96, 600), "staged"),
    ("degree_past_smem", (MAX_DEGREE, MAX_DEGREE, 600), "warp"),
    ("rows_not_float4", (32, 64, 37), "warp"),
    ("rows_past_1024", (16, 32, 1028), "warp"),
]


@pytest.mark.parametrize("name,shape,variant", SCAN_CASES,
                         ids=[c[0] for c in SCAN_CASES])
def test_alpha_scan_route_table(name, shape, variant):
    degree, l, d = shape
    assert scan_route(degree, l, d) == variant
    slots = staged_slots(degree, l, d)
    assert (slots > 0) == (variant == "staged" or d % 4 != 0 or d > 1024)
    assert 0 <= slots <= degree


def test_alpha_scan_route_needs_aligned_rows_for_staged():
    assert scan_route(32, 64, 600, aligned=False) == "warp"
    with pytest.raises(ValueError, match="staged variant"):
        scan_route(32, 64, 600, aligned=False, variant="staged")


@pytest.mark.parametrize("variant", SCAN_VARIANTS)
@pytest.mark.parametrize("shape", [(32, 64, 600), (32, 96, 600), (8, 8, 4)])
def test_alpha_scan_forced_variant_takes_the_path_shapes(variant, shape):
    assert scan_route(*shape, variant=variant) == variant


@pytest.mark.parametrize("shape", [(MAX_DEGREE, MAX_DEGREE, 600),
                                   (32, 64, 37), (16, 32, 1028)])
def test_alpha_scan_forced_staged_refuses_what_it_cannot_take(shape):
    with pytest.raises(ValueError, match="staged variant"):
        scan_route(*shape, variant="staged")
    assert scan_route(*shape, variant="warp") == "warp"


def test_alpha_scan_route_refuses_unknown_variants():
    with pytest.raises(ValueError, match="unknown variant"):
        scan_route(32, 64, 600, variant="block")


def test_alpha_scan_staged_layout_is_the_kernels():
    """staged_slots's constants are the ones the kernel is built with; at
    the path shapes 7 kept rows per warp stay in shared memory, three
    blocks of four warps share an SM, and an eighth slot would not fit."""
    src = (CSRC / "alpha_scan.cu").read_text()
    for name, value in (("kStagedWarps", STAGED_WARPS),
                        ("kStagedWarpsPerSm", STAGED_WARPS_PER_SM)):
        assert re.search(rf"{name} = (\d+);", src).group(1) == str(value)
    per_block = 233_472 // 3 - 1024
    for l in (32, 64, 96):
        assert staged_slots(32, l, 600) == 7
        assert 4 * staged_warp_bytes(32, l, 600, 7) <= per_block
        assert 4 * staged_warp_bytes(32, l, 600, 8) > per_block
    assert staged_slots(16, 48, 256) == 16          # recsys_ann: all kept
    assert staged_slots(32, 64, 1024) == 4
    assert staged_slots(MAX_DEGREE, MAX_DEGREE, 600) == 0
    assert staged_warp_bytes(32, 64, 600, 7) % 16 == 0


def test_alpha_scan_cpu_dispatch_ignores_the_variant_and_counts_nothing():
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.integers(-3, 4, (50, 8)).astype(np.float32))
    nodes = torch.arange(6, dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(-1, 50, (6, 12)).astype(np.int32))
    dists = torch.from_numpy(rng.random((6, 12)).astype(np.float32))
    dists = torch.sort(dists, dim=1).values
    before = (alpha_scan_cuda.launches, dict(alpha_scan_cuda.by_variant))
    want = alpha_scan_ref(data, nodes, ids, dists, 4, 1.2)
    for variant in (None, "warp", "staged"):
        got = alpha_scan(data, nodes, ids, dists, 4, 1.2, variant=variant)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (alpha_scan_cuda.launches, alpha_scan_cuda.by_variant) == before
    with pytest.raises(ValueError, match="on CUDA"):
        alpha_scan_cuda(data, nodes, ids, dists, 4, 1.2, variant="staged")
