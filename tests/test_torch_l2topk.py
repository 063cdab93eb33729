"""The port's exact L2 top-k (``kernels/l2topk``, routed under
``core.distances.l2_topk``) against the reference's.

1. The plain version (what a CPU tensor runs) against
   ``repro.core.distances.l2_topk``, the oracle of the reference's Pallas
   kernel: on integer-valued data every distance is exact, so ids and dists
   must be equal, ties included (lower id first); on float data dists to
   rtol 1e-5 and ids on >= 99% of rows.
2. The same inputs against the Pallas kernel ``l2_topk_pallas`` itself
   (``interpret=True``, as the reference's own tests run it). On tie-free
   data the ids are equal. On tied data the dists are equal, but the ids
   follow another tie rule: the Pallas kernel's ``_insert_sorted`` places
   each candidate before the equal entries already in its list, so a group
   of tied distances comes out in *descending* id order, while its oracle
   (and the port) put the lower id first. The groups inside the top-k hold
   the same ids; the group cut by k may not, once the database spans
   several blocks: a tied candidate of a later block goes in front of its
   equals and pushes the last (lower-id) one out. The port keeps the
   oracle's rule; the test pins the Pallas behaviour so the quirk stays
   written down.
3. Dispatch: a CPU tensor runs the plain version, ``backend="cuda"`` on a
   CPU tensor raises, and the CUDA wrapper refuses CPU tensors. Wide k
   (above the tile variant's 128-entry lists, the card's ``wide`` variant)
   equals the reference's oracle, ties included.
4. ``FlatIndex`` and ``recall_at_k`` against the reference's.
5. The CUDA wrapper's routing (a pure function of the shape): the main
   path's seven shapes and FlatIndex's wide k take the variants
   ``chip_smoke.py`` and PERF.md name,
   forced variants refuse shapes they cannot take, and every split plan
   fills one wave with no empty split.
6. The tensor-core variant's arithmetic, emulated in plain PyTorch: each
   input split into hi = tf32(v) and lo = tf32(v - hi) (bit masks, round to
   nearest), the dot product as hi.hi + hi.lo + lo.hi. It equals the
   plain version bit for bit on integer data and stays within its float
   tolerance, so the kNN table survives the tensor cores' arithmetic.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.distances import l2_topk as jax_l2_topk
from repro.core.distances import nearest as jax_nearest
from repro.core.flat import FlatIndex as JaxFlatIndex
from repro.core.flat import recall_at_k as jax_recall_at_k
from repro.kernels.l2topk.l2topk import l2_topk_pallas
from repro.kernels.l2topk.ref import l2_topk_ref as jax_l2_topk_ref
from repro_torch.core.distances import l2_topk, nearest
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
from repro_torch.kernels.l2topk.l2topk import (
    MAX_K, TC_BLOCK_N, TC_BLOCK_Q, TC_MAX_K, VARIANTS, route, split_plan,
    variant_for,
)
from repro_torch.kernels.l2topk.ops import l2_topk as l2_topk_dispatch
from repro_torch.kernels.l2topk.ref import pack_keys, unpack_keys

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ints(rng, shape, lo=-3, hi=3):
    return rng.integers(lo, hi + 1, shape).astype(np.float32)


def _port(q, x, k, **kw):
    d, i = l2_topk(torch.from_numpy(q), torch.from_numpy(x), k, **kw)
    return d.numpy(), i.numpy()


def _ref(q, x, k, **kw):
    d, i = jax_l2_topk(jnp.asarray(q), jnp.asarray(x), k, **kw)
    return np.asarray(d), np.asarray(i)


# (Q, N, D, k, chunk): k = 1, k > N, N not a multiple of chunk, D = 2
# (PQ's sub-spaces), Q = 1 (the medoid), and the kNN widths
SHAPES = [(40, 300, 8, 10, 128), (40, 300, 8, 1, 128), (7, 5, 8, 9, 16384),
          (33, 1000, 16, 33, 256), (64, 700, 2, 1, 256), (1, 900, 16, 5, 512),
          (25, 130, 8, 128, 64)]
SHAPE_IDS = ["k10", "k1", "k-over-n", "k33-ragged", "d2-pq", "q1",
             "k128"]


@pytest.mark.parametrize("q,n,d,k,chunk", SHAPES, ids=SHAPE_IDS)
def test_plain_l2_topk_equals_reference_on_integer_ties(q, n, d, k, chunk):
    rng = np.random.default_rng(q + n + d + k)
    # coordinates in [-1, 1]: many tied distances at every width
    x, qs = _ints(rng, (n, d), -1, 1), _ints(rng, (q, d), -1, 1)
    pd, pi = _port(qs, x, k, chunk=chunk)
    jd, ji = _ref(qs, x, k, chunk=chunk)
    assert pi.shape == (q, min(k, n))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)
    # ties really occur, and are ordered by id
    assert (np.diff(pd, axis=1) == 0).any() or min(k, n) == 1
    tied = np.diff(pd, axis=1) == 0
    assert (np.diff(pi, axis=1)[tied] > 0).all()


@pytest.mark.parametrize("q,n,d,k,chunk", SHAPES, ids=SHAPE_IDS)
def test_plain_l2_topk_float_data(q, n, d, k, chunk):
    rng = np.random.default_rng(7 * q + n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    qs = rng.standard_normal((q, d)).astype(np.float32)
    pd, pi = _port(qs, x, k, chunk=chunk)
    jd, ji = _ref(qs, x, k, chunk=chunk)
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert (pi == ji).all(1).mean() >= 0.99


@pytest.mark.parametrize("q,n,d,chunk", [(9, 700, 6, 256), (3, 300, 16, 128)])
@pytest.mark.parametrize("k", [129, 256, None])              # None: k = N
def test_wide_k_equals_the_reference_oracle_on_integer_ties(q, n, d, chunk,
                                                            k):
    """k past the tile variant's 128-entry lists (what the card's wide
    variant answers): the port's l2_topk on the CPU equals the reference's
    l2_topk_ref, ids and dists exact on integer data, tied distances in
    ascending id order, across chunk boundaries."""
    k = n if k is None else k
    rng = np.random.default_rng(n + d + k)
    x, qs = _ints(rng, (n, d), -1, 1), _ints(rng, (q, d), -1, 1)
    pd, pi = _port(qs, x, k, chunk=chunk)
    jd, ji = jax_l2_topk_ref(jnp.asarray(qs), jnp.asarray(x), k, chunk=chunk)
    assert pi.shape == (q, min(k, n))
    np.testing.assert_array_equal(pi, np.asarray(ji))
    np.testing.assert_array_equal(pd, np.asarray(jd))
    tied = np.diff(pd, axis=1) == 0
    assert tied.any() and (np.diff(pi, axis=1)[tied] > 0).all()
    if k == n:
        assert (np.sort(pi, axis=1) == np.arange(n)).all()


def test_nearest_equals_reference():
    rng = np.random.default_rng(3)
    x, qs = _ints(rng, (500, 8)), _ints(rng, (60, 8))
    pd, pi = nearest(torch.from_numpy(qs), torch.from_numpy(x), chunk=128)
    jd, ji = jax_nearest(jnp.asarray(qs), jnp.asarray(x), chunk=128)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def _tie_free(n, d, q, seed):
    """Integer data whose distances are all distinct and exact in f32:
    coordinates scaled by s > 2n plus a last coordinate equal to the row
    id, against queries whose last coordinate is -n, so a distance is
    s^2 A + (n + id)^2 with (n + id)^2 < s^2."""
    rng = np.random.default_rng(seed)
    s = 2 * n + 1
    x = np.concatenate([_ints(rng, (n, d - 1)) * s,
                        np.arange(n, dtype=np.float32)[:, None]], 1)
    qs = np.concatenate([_ints(rng, (q, d - 1)) * s,
                         np.full((q, 1), -n, np.float32)], 1)
    return x, qs


@pytest.mark.parametrize("k", [1, 6, 10])
def test_plain_l2_topk_equals_pallas_kernel_when_tie_free(k):
    x, qs = _tie_free(100, 4, 24, seed=k)
    pd, pi = _port(qs, x, k)
    gd, gi = l2_topk_pallas(jnp.asarray(qs), jnp.asarray(x), k,
                            block_q=8, block_n=32, interpret=True)
    assert all(len(np.unique(row)) == k for row in pd)
    np.testing.assert_array_equal(pi, np.asarray(gi))
    np.testing.assert_array_equal(pd, np.asarray(gd))


def test_pallas_kernel_reverses_tied_ids():
    """40 rows at 3 distinct distances from the query, k=6: the smallest
    distance is shared by ids 0, 3, ..., 39. The oracle and the port give
    [0 3 6 9 12 15]; the Pallas kernel the same set in descending order."""
    x = np.zeros((40, 8), np.float32)
    x[:, 0] = np.arange(40) % 3 + 1
    qs = np.zeros((1, 8), np.float32)
    pd, pi = _port(qs, x, 6)
    jd, ji = _ref(qs, x, 6)
    gd, gi = l2_topk_pallas(jnp.asarray(qs), jnp.asarray(x), 6,
                            interpret=True)
    np.testing.assert_array_equal(pi[0], [0, 3, 6, 9, 12, 15])
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(np.asarray(gi)[0], [15, 12, 9, 6, 3, 0])
    np.testing.assert_array_equal(pd, np.asarray(gd))


@pytest.mark.parametrize("k", [4, 9])
def test_plain_l2_topk_against_pallas_kernel_with_ties(k):
    """Random tied integer data over three database blocks: per row the
    dists are equal; each distance group inside the top-k holds the same
    ids in both, ascending in the port and descending in the Pallas
    kernel; the group cut by k holds as many ids, descending there too."""
    rng = np.random.default_rng(k)
    x, qs = _ints(rng, (96, 8), -1, 1), _ints(rng, (16, 8), -1, 1)
    pd, pi = _port(qs, x, k)
    gd, gi = l2_topk_pallas(jnp.asarray(qs), jnp.asarray(x), k,
                            block_q=8, block_n=32, interpret=True)
    gd, gi = np.asarray(gd), np.asarray(gi)
    np.testing.assert_array_equal(pd, gd)
    reversed_groups = 0
    for row in range(pd.shape[0]):
        for dist in np.unique(pd[row]):
            mine = pi[row][pd[row] == dist]
            theirs = gi[row][gd[row] == dist]
            assert (np.diff(mine) > 0).all()
            assert (np.diff(theirs) < 0).all()
            if dist != pd[row, -1]:            # not the group cut by k
                np.testing.assert_array_equal(mine, np.sort(theirs))
                reversed_groups += len(mine) > 1
    assert reversed_groups > 0


def test_cpu_tensors_run_the_plain_version():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    q = x[:20] + 0.1
    before = l2topk_cuda.launches
    by_variant = dict(l2topk_cuda.by_variant)
    got = l2_topk_dispatch(q, x, 7, chunk=64)
    want = l2_topk_ref(q, x, 7, chunk=64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert l2topk_cuda.launches == before
    assert l2topk_cuda.by_variant == by_variant


def test_forcing_the_kernel_on_cpu_tensors_raises():
    x = torch.zeros((10, 4))
    with pytest.raises(RuntimeError, match="backend='cuda'"):
        l2_topk_dispatch(x, x, 3, backend="cuda")
    with pytest.raises(ValueError, match="unknown l2topk backend"):
        l2_topk_dispatch(x, x, 3, backend="pallas")
    with pytest.raises(ValueError, match="on CUDA"):
        l2topk_cuda(x, x, 3)


def test_split_plan_fills_one_wave_and_leaves_no_split_empty():
    sms = 132
    for nq, n in [(4096, 300_000), (4096, 270_000), (1024, 300_000),
                  (270_000, 256), (1, 270_000), (1024, 64), (5, 129),
                  (256, 20_000)]:
        splits, per = split_plan(nq, n, sms)
        n_tiles = -(-n // 128)
        q_tiles = -(-nq // 64)
        assert splits >= 1 and (splits - 1) * per < n_tiles <= splits * per
        assert splits == 1 or q_tiles * splits <= 2 * sms
        # the tensor-core variant: one 128 x 256 block per SM
        variant, splits, per = route(nq, n, 768, 10, sms, "tc")
        n_tiles, q_tiles = -(-n // TC_BLOCK_N), -(-nq // TC_BLOCK_Q)
        assert variant == "tc"
        assert splits >= 1 and (splits - 1) * per < n_tiles <= splits * per
        assert splits == 1 or q_tiles * splits <= sms
    assert split_plan(1, 270_000, sms)[0] == 2 * sms
    assert route(4096, 300_000, 768, 11, sms)[1:] == (4, 293)
    assert route(1024, 300_000, 768, 10, sms)[1:] == (16, 74)
    assert MAX_K == 128


def test_path_shapes_take_the_variants_perf_names():
    smoke = _chip_smoke()
    shapes = smoke.l2topk_shapes()
    assert set(shapes) == set(smoke.L2TOPK_ROUTES)
    for name, (q, n, d, k) in shapes.items():
        assert variant_for(q, n, d, min(k, n)) == smoke.L2TOPK_ROUTES[name]
        plan = route(q, n, d, min(k, n), 132)
        assert plan.variant == smoke.L2TOPK_ROUTES[name]
    assert {v for v in smoke.L2TOPK_ROUTES.values()} == set(VARIANTS)


@pytest.mark.parametrize("shape,variant", [
    ((1000, 256, 2, 1), "small"), ((1000, 300, 2, 1), "tile"),
    ((500, 256, 8, 16), "small"), ((500, 256, 9, 16), "tile"),
    ((500, 256, 2, 17), "tile"), ((128, 1024, 32, 64), "tc"),
    ((127, 1024, 32, 64), "tile"), ((128, 1023, 32, 64), "tile"),
    ((128, 1024, 31, 64), "tile"), ((128, 1024, 32, 65), "tile"),
    ((1, 270_000, 600, 1), "tile"), ((77, 1000, 64, 128), "tile")])
def test_route_boundaries(shape, variant):
    q, n, d, k = shape
    assert variant_for(q, n, d, k) == variant
    assert route(q, n, d, k, 132).variant == variant


def test_forced_variants_refuse_what_they_cannot_take():
    assert route(5, 3, 16, 3, 132, "tc").variant == "tc"
    assert route(1, 300_000, 600, 1, 132, "tile").variant == "tile"
    with pytest.raises(ValueError, match="small variant"):
        route(10, 257, 2, 1, 132, "small")
    with pytest.raises(ValueError, match="small variant"):
        route(10, 256, 9, 1, 132, "small")
    with pytest.raises(ValueError, match="tc variant"):
        route(500, 5000, 600, TC_MAX_K + 1, 132, "tc")

    with pytest.raises(ValueError, match="unknown variant"):
        route(500, 5000, 600, 10, 132, "wgmma")


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit masks: half a TF32 ulp added to the
    magnitude, then the low 13 mantissa bits cleared (round to nearest,
    ties away from zero)."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _l2_topk_3xtf32(q: torch.Tensor, x: torch.Tensor, k: int):
    """The tc variant's function in plain PyTorch: norms in f32, each dot
    product from TF32 hi/lo splits with the lo.lo term dropped (every
    product of two TF32 values is exact in f32)."""
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    dot = qh @ xh.T + qh @ xl.T + ql @ xh.T
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    dist = ((qn + xn[None, :]) - 2.0 * dot).clamp_min(0.0)
    ids = torch.arange(x.shape[0])[None, :].expand(q.shape[0], -1)
    keys = torch.topk(pack_keys(dist, ids), min(k, x.shape[0]), dim=1,
                      largest=False, sorted=True).values
    return unpack_keys(keys)


def test_tf32_split_rounds_to_nearest_and_keeps_the_remainder():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0, -2048.0, 1e-3, 0.1])
    hi = _tf32(v)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert hi[1] == 1.0 + 2.0 ** -10 and hi[3] == -(1.0 + 2.0 ** -10)
    assert hi[2] == 1.0 + 2.0 ** -10 and hi[0] == 1.0 and hi[5] == -2048.0
    lo = _tf32(v - hi)
    # hi + lo carries v to ~2^-21 relative; integers up to 2048 split exactly
    assert ((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all()
    assert lo[4] == 0 and lo[5] == 0


@pytest.mark.parametrize("q,n,d,k", [(64, 2000, 600, 33), (48, 3000, 768, 11),
                                     (200, 800, 37, 10), (1, 5000, 600, 1)])
def test_3xtf32_dot_keeps_the_plain_versions_results(q, n, d, k):
    rng = np.random.default_rng(q + n + d)
    xi = torch.from_numpy(_ints(rng, (n, d), -1, 1))
    qi = torch.from_numpy(_ints(rng, (q, d), -1, 1))
    ed, ei = _l2_topk_3xtf32(qi, xi, k)
    pd, pi = l2_topk_ref(qi, xi, k)
    assert torch.equal(ei, pi) and torch.equal(ed.view(torch.int32),
                                               pd.view(torch.int32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32))
    ed, ei = _l2_topk_3xtf32(qs, x, k)
    pd, pi = l2_topk_ref(qs, x, k)
    torch.testing.assert_close(ed, pd, rtol=1e-5, atol=1e-5)
    assert (ei == pi).all(1).float().mean() >= 0.99
    # TF32 alone (hi.hi) moves the distances well past that tolerance
    hd = ((qs * qs).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :]
          - 2.0 * (_tf32(qs) @ _tf32(x).T)).clamp_min(0.0)
    full = ((qs * qs).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :]
            - 2.0 * (qs @ x.T)).clamp_min(0.0)
    assert ((hd - full).abs() > 1e-5 + 1e-5 * full.abs()).any()


def test_flat_index_and_recall_equal_reference():
    rng = np.random.default_rng(9)
    x, qs = _ints(rng, (400, 8)), _ints(rng, (30, 8))
    jd, ji = JaxFlatIndex(jnp.asarray(x)).search(jnp.asarray(qs), 10,
                                                 chunk=128)
    flat = FlatIndex(torch.from_numpy(x))
    pd, pi = flat.search(qs, 10, chunk=128)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert (flat.ntotal, flat.dim, flat.memory_bytes()) == (400, 8, 400 * 32)
    again = FlatIndex.from_state(flat.state_dict(), device="cpu")
    assert torch.equal(again.search(qs, 10)[1], pi)
    assert "chunk" in flat.search_params_space().names()
    # a prediction that is half right, with one -1 pad
    pred = np.array(ji)[:, :10].copy()
    pred[:, 5:] = (pred[:, 5:] + 1) % 400
    pred[0, 0] = -1
    assert recall_at_k(torch.from_numpy(pred), pi) == pytest.approx(
        jax_recall_at_k(jnp.asarray(pred), ji), abs=1e-6)
