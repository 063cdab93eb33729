"""The port's kernels against the reference's.

On the CPU the port's ops run their plain PyTorch versions; these are held
to the reference's jnp refs and to its Pallas kernels in interpret mode.
Integer-valued f32 inputs make every distance an exact integer whatever
the reduction order, so ids, distances, visited flags and counters must
match exactly — and the many ties they produce test the tie rules. Float
inputs hold distances to rtol = atol = 1e-5 (the reduction order over D
differs between XLA and PyTorch).

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels need core first)
from repro.kernels.beam_hop import beam_hop_pallas
from repro.kernels.beam_hop import beam_hop_ref as jax_beam_hop_ref
from repro.kernels.gather_dist import gather_dist as jax_gather_dist
from repro.kernels.topk_merge import topk_pool as jax_topk_pool
from repro.kernels.topk_merge.ref import topk_merge_ref as jax_topk_merge_ref
from repro.kernels.topk_merge.ref import topk_pool_ref as jax_topk_pool_ref
from repro_torch.kernels.beam_hop import beam_hop
from repro_torch.kernels.gather_dist import gather_dist
from repro_torch.kernels.topk_merge import topk_merge, topk_pool

TOL = dict(rtol=1e-5, atol=1e-5)


def _vectors(rng, shape, kind, lo=-8, hi=8):
    if kind == "int":
        return rng.integers(lo, hi + 1, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_same(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    if kind == "int" or got.dtype != np.float32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# -------------------------------------------------------------- gather_dist
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("b,n,d,r", [(3, 40, 8, 4), (8, 200, 32, 16)])
def test_gather_dist_matches_reference(kind, b, n, d, r):
    rng = np.random.default_rng(b * n + d)
    q, db = _vectors(rng, (b, d), kind), _vectors(rng, (n, d), kind)
    ids = rng.integers(-1, n, (b, r)).astype(np.int32)
    got = gather_dist(*_t(q, db, ids)).numpy()
    assert np.isinf(got[ids < 0]).all()
    for backend in ("jnp", "pallas"):
        want = jax_gather_dist(jnp.asarray(q), jnp.asarray(db),
                               jnp.asarray(ids), backend=backend)
        _assert_same(got, want, kind)


# ------------------------------------------------------------------ beam_hop
def _hop_inputs(rng, kind, nq=12, n=200, d=16, r=8, ef=16):
    """A mid-search hop state: pools with -1/inf padding and visited marks,
    inactive lanes (sel < 0), graph rows with -1 entries, ids repeated
    inside a row and ids already in the pool. Integer data uses small
    coordinates, so candidate and pool distances tie often."""
    lo, hi = (-2, 2) if kind == "int" else (-8, 8)
    db = _vectors(rng, (n, d), kind, lo, hi)
    q = _vectors(rng, (nq, d), kind, lo, hi)
    nbrs = rng.integers(-1, n, (n, r)).astype(np.int32)
    nbrs[:, 1] = nbrs[:, 0]                       # repeats within a row
    pool_i = rng.integers(-1, n, (nq, ef)).astype(np.int32)
    scale = 40 if kind == "int" else 60.0
    pd = (rng.integers(0, scale, (nq, ef)) if kind == "int"
          else rng.random((nq, ef)) * scale).astype(np.float32)
    pool_d = np.sort(np.where(pool_i >= 0, pd, np.inf), axis=1)
    pool_d = pool_d.astype(np.float32)
    pool_v = (pool_i < 0) | (rng.random((nq, ef)) < 0.3)
    sel = rng.integers(0, n, nq).astype(np.int32)
    sel[::3] = -1                                 # inactive lanes
    nbrs[sel[sel >= 0], 2:5] = pool_i[sel >= 0, :3]   # pool duplicates
    return sel, nbrs, pool_i, pool_d, pool_v, q, db


@pytest.mark.parametrize("kind", ["int", "float"])
def test_beam_hop_matches_reference(kind):
    rng = np.random.default_rng(5)
    inputs = _hop_inputs(rng, kind)
    got = beam_hop(*_t(*inputs))
    j = [jnp.asarray(a) for a in inputs]
    refs = (jax_beam_hop_ref(*j),
            beam_hop_pallas(*j, dist_backend="f32", interpret=True))
    for want in refs:
        for g_, w_ in zip(got, want):
            _assert_same(g_.numpy(), w_, kind)
    stats = got[3].numpy()
    assert (stats[::3] == 0).all()                # inactive lanes
    assert stats[:, 1].sum() > 0                  # duplicates were seen


def test_beam_hop_inactive_lanes_keep_their_pool():
    rng = np.random.default_rng(9)
    sel, nbrs, pool_i, pool_d, pool_v, q, db = _hop_inputs(rng, "int")
    sel[:] = -1
    out_i, out_d, out_v, stats = beam_hop(
        *_t(sel, nbrs, pool_i, pool_d, pool_v, q, db))
    np.testing.assert_array_equal(out_i.numpy(), pool_i)
    np.testing.assert_array_equal(out_d.numpy(), pool_d)
    np.testing.assert_array_equal(out_v.numpy(), pool_v)
    assert (stats.numpy() == 0).all()


# --------------------------------------------------------------- topk_merge
def _tied_candidates(rng, b, m, n_ids, *, keyed):
    """Integer-valued candidate rows with -1 ids, repeated ids and tied
    distances. ``keyed``: a repeated id carries one distance per row (what
    the NSG build feeds topk_pool); otherwise copies may differ."""
    ids = rng.integers(-1, n_ids, (b, m)).astype(np.int32)
    if keyed:
        table = rng.integers(0, 6, (b, n_ids)).astype(np.float32)
        ds = np.take_along_axis(table, np.maximum(ids, 0), 1)
    else:
        ds = rng.integers(0, 6, (b, m)).astype(np.float32)
    ds[rng.random((b, m)) < 0.05] = np.inf
    return ids, np.where(ids >= 0, ds, np.inf).astype(np.float32)


@pytest.mark.parametrize("keyed", [True, False])
@pytest.mark.parametrize("b,m,k", [(16, 37, 9), (8, 96, 64), (5, 8, 8)])
def test_topk_pool_matches_reference(keyed, b, m, k):
    rng = np.random.default_rng(m + k)
    ids, ds = _tied_candidates(rng, b, m, 2 * m, keyed=keyed)
    gi, gd = topk_pool(*_t(ids, ds), k)
    wi, wd = jax_topk_pool_ref(jnp.asarray(ids), jnp.asarray(ds), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_topk_pool_matches_pallas_kernel():
    """Distinct distances per id: the Pallas kernel's own contract."""
    rng = np.random.default_rng(3)
    b, m, k = 8, 24, 8
    ids = rng.integers(-1, 2 * m, (b, m)).astype(np.int32)
    table = rng.random((b, 2 * m)).astype(np.float32) + 0.01
    ds = np.where(ids >= 0, np.take_along_axis(table, np.maximum(ids, 0), 1),
                  np.inf).astype(np.float32)
    gi, gd = topk_pool(*_t(ids, ds), k)
    wi, wd = jax_topk_pool(jnp.asarray(ids), jnp.asarray(ds), k,
                           backend="pallas", block_rows=8)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("b,kcur,m,k", [(16, 8, 19, 8), (6, 12, 44, 30),
                                        (5, 4, 3, 6)])
def test_topk_merge_matches_reference(b, kcur, m, k):
    rng = np.random.default_rng(b + m)
    cur_i, cur_d = _tied_candidates(rng, b, kcur, 3 * m, keyed=False)
    cur_f = (rng.random((b, kcur)) < 0.5) & (cur_i >= 0)
    cand_i, cand_d = _tied_candidates(rng, b, m, 3 * m, keyed=False)
    got = topk_merge(*_t(cur_i, cur_d, cur_f, cand_i, cand_d), k)
    want = jax_topk_merge_ref(*(jnp.asarray(a) for a in
                                (cur_i, cur_d, cur_f, cand_i, cand_d)), k)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))


# ------------------------------------------------------------------ dispatch
def test_forcing_the_kernel_on_cpu_tensors_raises():
    rng = np.random.default_rng(0)
    q, db = _t(_vectors(rng, (2, 8), "int"), _vectors(rng, (10, 8), "int"))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_dist(q, db, ids, backend="cuda")
    hop = _t(*_hop_inputs(rng, "int"))
    with pytest.raises(RuntimeError, match="CUDA"):
        beam_hop(*hop, backend="cuda")
    d = torch.zeros((2, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        topk_pool(ids, d, 2, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        topk_merge(ids, d, ids >= 0, ids, d, 2, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        gather_dist(q, db, ids, backend="torch")
