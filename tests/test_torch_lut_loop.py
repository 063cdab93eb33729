"""The LUT-mode hop loop: the launch plan its wrapper takes on the card
(``kernels/beam_hop/beam_hop.py:route``), and the loop's plain version at
int8's width against the reference.

``route`` is plain arithmetic over the shape and the card's L2 size and SM
count, so it is held here over a table of cases; the kernels it picks run
only on the card (``tests/test_torch_cuda.py``). The plain loop
(``beam_hops_ref``, which the port runs on the CPU) is held at M = 600, C =
256 against the reference's guarded ``_run_hops`` through its staged LUT
hop (the jnp ``lut_dist`` oracle), every field of the loop state, exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro_torch.kernels.beam_hop.beam_hop import (
    L2_SHARE, SMEM_PER_BLOCK, THREADS, LutPlan, _check_plan,
    persistent_smem_bytes, route,
)

MB = 1 << 20
H100 = dict(l2_bytes=50 * MB, sm_count=132)

# (M, C, R, ef, L2 bytes) -> the plan
ROUTE_CASES = [
    # pq and int8 serving at ann-laion's widths on an H100
    ((300, 256, 32, 64, 50 * MB), LutPlan("persistent", 132, 200)),
    ((600, 256, 32, 64, 50 * MB), LutPlan("persistent", 132, 148)),
    # a small L2 leaves the grid; below one LUT's L2 part, per_query
    ((300, 256, 32, 64, 1 * MB), LutPlan("persistent", 132, 200)),
    ((600, 256, 32, 64, 4 * MB), LutPlan("persistent", 132, 148)),
    ((600, 256, 32, 64, MB // 4), LutPlan("per_query", 0, 0)),
    # small LUTs sit in shared memory whole: no L2 part, a block per SM
    ((300, 16, 32, 64, 50 * MB), LutPlan("persistent", 132, 300)),
    ((7, 1, 12, 16, 1024), LutPlan("persistent", 132, 7)),
    ((1, 256, 32, 64, 0), LutPlan("persistent", 132, 1)),
    # the staging buffer alone outgrows a block: per_query
    ((2048, 256, 32, 64, 50 * MB), LutPlan("per_query", 0, 0)),
    ((1600, 16, 32, 64, 50 * MB), LutPlan("per_query", 0, 0)),
    # more candidates per hop than threads: per_query
    ((300, 256, THREADS + 1, 64, 50 * MB), LutPlan("per_query", 0, 0)),
]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,plan", ROUTE_CASES,
                         ids=[f"m{s[0]}-c{s[1]}-r{s[2]}-l2{s[4]}"
                              for s, _ in ROUTE_CASES])
def test_route_table(shape, plan):
    m, c, r, ef, l2 = shape
    assert route(m, c, r, ef, l2, H100["sm_count"]) == plan


SWEEP = [(m, c, l2) for m in (1, 3, 4, 7, 64, 300, 301, 600, 1000)
         for c in (1, 16, 255, 256) for l2 in (2 * MB, 50 * MB)]


@pytest.mark.parametrize("m,c,l2", SWEEP)
def test_route_plans_fit_the_card(m, c, l2):
    """A persistent plan fits a block's shared memory, keeps whole resident
    groups of 4 sub-tables (or all M), takes the most resident sub-tables
    that fit, keeps one LUT's L2 part within the L2 share and puts a block
    on every SM; per_query only where nothing resident does not fit or one
    LUT's L2 part is over the share."""
    r, ef = 32, 64
    plan = route(m, c, r, ef, l2, H100["sm_count"])
    cap = SMEM_PER_BLOCK
    fits = persistent_smem_bytes(ef, r, m, c, 0) <= cap
    if plan.variant == "per_query":
        assert not fits or m * c * 4 > L2_SHARE * l2
        return
    assert plan.resident == m or plan.resident % 4 == 0
    assert persistent_smem_bytes(ef, r, m, c, plan.resident) <= cap
    more = m if plan.resident + 4 > m else plan.resident + 4
    if more != plan.resident:
        assert persistent_smem_bytes(ef, r, m, c, more) > cap
    assert (m - plan.resident) * c * 4 <= L2_SHARE * l2
    assert plan.grid == H100["sm_count"]
    _check_plan("test", plan, m, c, r, ef)


@pytest.mark.parametrize("plan", [
    LutPlan("resident", 1, 0),                 # no such variant
    LutPlan("persistent", 0, 0),               # an empty grid
    LutPlan("persistent", 8, 6),               # not a group of 4
    LutPlan("persistent", 8, 304),             # beyond M
    LutPlan("persistent", 8, 300),             # 300 KB of shared memory
])
def test_forced_plans_the_kernel_cannot_take_are_refused(plan):
    with pytest.raises(ValueError):
        _check_plan("beam_hops_lut_cuda", plan, 300, 256, 32, 64)


def test_smem_layout_counts_each_region():
    """Pools, keys and control words; odd-word code rows; the staging
    buffer and the resident sub-tables, each region 16-byte aligned."""
    ef, r, m, c = 64, 32, 300, 256
    hop = (ef + r) * 8 + (6 * ef + 3 * r + 8) * 4          # 2,720 B
    codes = -(-hop // 16) * 16 + r * 75 * 4                # 75 words: odd
    assert persistent_smem_bytes(ef, r, m, c, 0) == \
        -(-codes // 16) * 16 + m * r * 4
    assert persistent_smem_bytes(ef, r, m, c, 200) == \
        -(-codes // 16) * 16 + 100 * r * 4 + 200 * c * 4
    # M = 599 and 600 both take 151-word rows (150 is even): one more
    # staging row between them
    assert persistent_smem_bytes(ef, r, 600, c, 0) - \
        persistent_smem_bytes(ef, r, 599, c, 0) == 4 * r


# -- the plain loop at int8's width against the reference's loop

INT8_M, INT8_C, EF, K, ITERS = 600, 256, 16, 10, 40


@pytest.fixture(scope="module")
def int8_width_case():
    """A kNN graph the reference built over integer rows (with -1 pads),
    codes over all 256 levels and a float LUT at M = 600."""
    rng = np.random.default_rng(17)
    data = rng.integers(-3, 4, (500, 8)).astype(np.float32)
    _, ids = jax_knn_graph(jnp.asarray(data), 10)
    nbrs = np.array(ids)
    nbrs[::7, 8:] = -1
    queries = rng.integers(-3, 4, (24, 8)).astype(np.float32)
    entry = rng.integers(0, 500, 24).astype(np.int32)
    codes = rng.integers(0, INT8_C, (500, INT8_M)).astype(np.uint8)
    lut = (rng.random((24, INT8_M, INT8_C)) * 10).astype(np.float32)
    return queries, data, nbrs, entry, codes, lut


def _jax_setup(q, db, nbrs, codes, lut):
    from repro.core.beam_search import _batched_hop_setup
    return _batched_hop_setup(q, db, nbrs, gather_dist=None,
                              gather_backend="jnp", dist_backend="int8",
                              codes=codes, lut=lut, hop_backend="staged")


@functools.partial(jax.jit, static_argnames=("mode", "patience"))
def _jax_loop(q, db, nbrs, entry, codes, lut, *, mode, patience):
    from repro.core.beam_search import _run_hops, _seed_batched
    gd, body = _jax_setup(q, db, nbrs, codes, lut)
    state = _seed_batched(q, db, nbrs, entry, EF, gd)
    return state, _run_hops(state, body, k=K, max_iters=ITERS, mode=mode,
                            patience=patience, eps=0.0)


@pytest.mark.parametrize("mode,patience,max_steps",
                         [("while", None, ITERS), ("fori", 2, 7)])
def test_plain_loop_at_int8_width_equals_the_reference(int8_width_case,
                                                       mode, patience,
                                                       max_steps):
    from repro_torch.core.beam_search import _run_hop_slices
    queries, data, nbrs, entry, codes, lut = int8_width_case
    seed, want = _jax_loop(*(jnp.asarray(a) for a in int8_width_case),
                           mode=mode, patience=patience)
    state = tuple(torch.from_numpy(np.array(a)) for a in seed)
    got = _run_hop_slices(state, torch.from_numpy(lut),
                          torch.from_numpy(codes), torch.from_numpy(nbrs),
                          "int8", k=K, max_iters=ITERS, mode=mode,
                          patience=patience, eps=0.0, max_steps=max_steps)
    names = ("ids", "dists", "visited", "hops", "gathered", "dup_gathered",
             "wasted", "stale")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert int(got[3].sum()) > 0
