"""The launch routes of the ``topk_merge`` and ``lut_dist`` wrappers.

``route`` is plain arithmetic over the shape, so it is held here: the
variant each main-path shape takes, each boundary, and the forced variants
that must be refused. The kernels it picks run only on the card
(``tests/test_torch_cuda.py``, ``-k topk`` and ``-k lut_dist``). On the
CPU the dispatchers run the plain versions and count no launch.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

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
