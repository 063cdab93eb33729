"""The port's NN-Descent against the reference's, with the reference's draws.

torch cannot reproduce ``jax.random``, so ``JaxDraws`` makes the
reference's own draws (its key splits: one per init pass and per round;
``kf, ko, kr, kh`` per round, ``kr1, kr2`` from ``kr``) and the port takes
them through its ``draws`` argument. On integer data (values < 16, D <= 16)
every distance is exact in f32, so the random-projection join, the seed
fold, one round and a whole run must equal the reference's exactly — ids,
dists, fresh flags, changed counts and evaluation counts — held to the
reference's jnp merge (``merge_backend="jnp"``), not its Pallas flavour.
The duplicate-index scatters and the uint32 hashes are held to the
reference's ``.at[].set`` and to numpy's uint32 arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build import knn_graph_recall as jax_knn_graph_recall
from repro.core.build.nn_descent import _rp_block_join as jax_rp_block_join
from repro.core.build.nn_descent import _round as jax_round
from repro.core.build.nn_descent import _seed_from_init as jax_seed_from_init
from repro.core.build.nn_descent import nn_descent as jax_nn_descent
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro_torch.core.build import build_knn, knn_graph_recall
from repro_torch.core.build.nn_descent import (
    NNDDraws, RoundDraws, _rp_block_join, _round, _seed_from_init,
    nn_descent,
)
from repro_torch.core.build.scatter import hash_slot, last_writer, \
    nearest_last_writer, scatter_min

I32_MAX = int(jnp.iinfo(jnp.int32).max)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _t(a):
    return torch.from_numpy(np.array(a))


_jax_order = jax.jit(lambda key, data: jnp.argsort(
    data @ jax.random.normal(key, (data.shape[1],))).astype(jnp.int32))


def jax_round_draws(key, n, k, s_rev) -> RoundDraws:
    """One round's draws as the reference's ``_round`` makes them."""
    kf, ko, kr, kh = jax.random.split(key, 4)
    kr1, kr2 = jax.random.split(kr)
    return RoundDraws(
        _t(jax.random.uniform(kf, (n, k))), _t(jax.random.uniform(ko, (n, k))),
        _t(jax.random.randint(kr1, (n * k,), 0, s_rev)).long(),
        _t(jax.random.randint(kr2, (n * k,), 0, s_rev)).long(),
        int(jax.random.randint(kh, (), 0, I32_MAX)))


class JaxDraws:
    """The reference's draws for one ``nn_descent`` run: ``key, sub =
    split(key)`` per init pass and per round. The projection order is
    the reference's ``argsort(data @ normal(sub, (D,)))``."""

    def __init__(self, key):
        self.key = key

    def _sub(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def rp_order(self, data):
        return _t(_jax_order(self._sub(), jnp.asarray(data.cpu().numpy())))

    def round(self, n, k, s_rev, device):
        return jax_round_draws(self._sub(), n, k, s_rev)


def _int_data(seed, n, d):
    return np.random.default_rng(seed).integers(0, 16, (n, d)).astype(
        np.float32)


def _state(seed, n, k, data):
    """A mid-build table: the reference's NN-Descent after its init
    passes and two rounds (so fresh and old flags are both present)."""
    d, i = jax_knn_graph(jnp.asarray(data), k)
    rng = np.random.default_rng(seed)
    ids = np.array(i)
    ids[rng.random(ids.shape) < 0.3] = -1                  # holes to fill
    dists = np.where(ids >= 0, np.array(d), np.inf).astype(np.float32)
    order = np.argsort(dists, axis=1, kind="stable")
    ids = np.take_along_axis(ids, order, 1)
    dists = np.take_along_axis(dists, order, 1)
    fresh = (rng.random(ids.shape) < 0.5) & (ids >= 0)
    return ids.astype(np.int32), dists, fresh


# -- the scatter and hash primitives ----------------------------------------

def test_hash_slot_equals_numpy_uint32():
    """Ids near 2**31, -1 (0xFFFFFFFF as uint32) and salts above 2**31."""
    vals = np.array([0, 1, -1, 2 ** 31 - 1, 2 ** 31 - 2, 123456789,
                     2 ** 30 + 7, 987654321, -2], np.int64)
    for salt in (0, 1, 0x9E3779B9, 2 ** 31 - 2, 0xFFFFFFFF, 2 ** 31):
        for slots in (1, 7, 40, 64, 256, 1000):
            h = (vals.astype(np.uint32) ^ np.uint32(salt)) \
                * np.uint32(2654435761)
            _eq(hash_slot(torch.from_numpy(vals), slots, salt),
                (h % np.uint32(slots)).astype(np.int64))


@pytest.mark.parametrize("collide", [False, True])
def test_last_writer_equals_the_ordered_scatter(collide):
    """``.at[rows, cols].set(arange, mode="drop")`` with and without
    duplicate cells: the last writer wins, row n is dropped."""
    rng = np.random.default_rng(3)
    n, s, m = 50, 8, 300
    if collide:
        rows = rng.integers(0, n + 1, m)             # n = dropped
        cols = rng.integers(0, s, m)
    else:
        cells = rng.permutation(n * s)[:m]
        rows, cols = cells // s, cells % s
        rows[::7] = n
    want = jnp.full((n, s), -1, jnp.int32).at[rows, cols].set(
        jnp.arange(m, dtype=jnp.int32), mode="drop")
    got = last_writer(torch.from_numpy(rows * s + cols), (n + 1) * s)
    _eq(got.view(n + 1, s)[:n], want)
    if collide:
        assert len(set(zip(rows[rows < n], cols[rows < n]))) < (rows < n).sum()


@pytest.mark.parametrize("collide", [False, True])
def test_scatter_min_equals_the_reference(collide):
    rng = np.random.default_rng(4)
    n, m = 40, 200 if collide else 30
    idx = rng.integers(0, n + 1, m) if collide else \
        rng.permutation(n + 1)[:m]
    src = rng.integers(0, 9, m).astype(np.float32)
    want = jnp.full((n,), jnp.inf).at[idx].min(src, mode="drop")
    got = scatter_min(torch.from_numpy(idx), torch.from_numpy(src), n + 1,
                      float("inf"))
    _eq(got[:n], want)


@pytest.mark.parametrize("collide", [False, True])
def test_nearest_last_writer_equals_min_then_winner_scatter(collide):
    """The reference's two-step winner (scatter-min, then the last writer
    among the entries at the minimum) on tied integer values, +inf and
    dropped cells."""
    rng = np.random.default_rng(5)
    n, s, m = 30, 4, 400 if collide else 60
    if collide:
        rows, cols = rng.integers(0, n + 1, m), rng.integers(0, s, m)
    else:
        cells = rng.permutation((n + 1) * s)[:m]
        rows, cols = cells // s, cells % s
    d = rng.integers(0, 4, m).astype(np.float32)
    d[rng.random(m) < 0.1] = np.inf
    val = rng.integers(0, 1000, m).astype(np.int32)
    blk_d = jnp.full((n, s), jnp.inf).at[rows, cols].min(d, mode="drop")
    win = (d <= blk_d[np.minimum(rows, n - 1), cols]) & (rows < n)
    want_v = jnp.full((n, s), -1, jnp.int32).at[
        np.where(win, rows, n), cols].set(val, mode="drop")
    cell = torch.from_numpy(rows * s + cols)
    pos, first = nearest_last_writer(cell, torch.from_numpy(d))
    got_d = torch.full(((n + 1) * s,), float("inf"))
    got_v = torch.full(((n + 1) * s,), -1, dtype=torch.int32)
    sel = pos[first]
    got_d[cell[sel]] = torch.from_numpy(d)[sel]
    got_v[cell[sel]] = torch.from_numpy(val)[sel]
    _eq(got_d.view(n + 1, s)[:n], blk_d)
    _eq(got_v.view(n + 1, s)[:n], want_v)


# -- the build steps ------------------------------------------------------------

@pytest.mark.parametrize("n,d,k,bsize", [(300, 8, 12, 32), (517, 16, 20, 7)])
def test_rp_block_join_equals_reference(n, d, k, bsize):
    data = _int_data(0, n, d)
    ids, dists, fresh = _state(1, n, k, data)
    key = jax.random.PRNGKey(5)
    norms = (data * data).sum(1)
    want = jax_rp_block_join(key, jnp.asarray(data), jnp.asarray(norms),
                             jnp.asarray(ids), jnp.asarray(dists),
                             jnp.asarray(fresh), bsize, 128, "jnp")
    got = _rp_block_join(_t(_jax_order(key, jnp.asarray(data))),
                         _t(data), _t(norms), _t(ids), _t(dists), _t(fresh),
                         bsize, 128)
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)
    assert int(got[3]) == int(jnp.sum(want[3]))


def test_seed_from_init_equals_reference():
    n, d, k = 400, 12, 16
    data = _int_data(2, n, d)
    rng = np.random.default_rng(2)
    init = rng.integers(-1, n + 5, (n, 10)).astype(np.int32)  # -1, >= n
    init[:, 0] = np.arange(n)                                 # self
    norms = (data * data).sum(1)
    empty = (np.full((n, k), -1, np.int32),
             np.full((n, k), np.inf, np.float32), np.zeros((n, k), bool))
    want = jax_seed_from_init(jnp.asarray(data), jnp.asarray(norms),
                              *(jnp.asarray(a) for a in empty),
                              jnp.asarray(init), 128, "jnp")
    got = _seed_from_init(_t(data), _t(norms), *(_t(a) for a in empty),
                          _t(init), 128)
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("n,d,k,s_rev,u_slots", [
    (300, 8, 12, 5, 24),       # the defaults' shape: s_rev = s_fwd
    (450, 16, 10, 1, 4),       # one reverse slot, four hash slots: many
])                             # colliding writes into each cell
def test_one_round_equals_reference(n, d, k, s_rev, u_slots):
    data = _int_data(3, n, d)
    ids, dists, fresh = _state(4, n, k, data)
    norms = (data * data).sum(1)
    key = jax.random.PRNGKey(11)
    want = jax_round(key, jnp.asarray(data), jnp.asarray(norms),
                     jnp.asarray(ids), jnp.asarray(dists),
                     jnp.asarray(fresh), 5, s_rev, u_slots, 128, "jnp")
    got = _round(jax_round_draws(key, n, k, s_rev), _t(data), _t(norms),
                 _t(ids), _t(dists), _t(fresh), 5, s_rev, u_slots, 128)
    for g, w in zip(got[:3], want[:3]):       # ids, dists, fresh
        _eq(g, w)
    assert int(got[3]) == int(want[3]) > 0    # changed
    assert int(got[4]) == int(jnp.sum(want[4]))


@pytest.mark.parametrize("case", ["defaults", "init_ids", "tiny"])
def test_nn_descent_equals_reference(case):
    """A whole run with its BuildStats; with a caller's init table (the
    AntiHub-subset reuse path: one init pass, three rounds); and the
    tiny-N padding (k >= N)."""
    if case == "tiny":
        n, d, k, kw = 6, 4, 8, {}
    else:
        n, d, k, kw = 600, 12, 10, dict(block=256)
    data = _int_data(6, n, d)
    if case == "init_ids":
        init = np.random.default_rng(6).integers(-1, n, (n, 10))
        kw.update(init_ids=init.astype(np.int32), init_passes=1, rounds=3)
    key = jax.random.PRNGKey(7)
    jkw = {**kw, "init_ids": jnp.asarray(kw["init_ids"])} \
        if "init_ids" in kw else kw
    wd, wi, ws = jax_nn_descent(jnp.asarray(data), k, key=key,
                                merge_backend="jnp", with_stats=True, **jkw)
    pkw = {**kw, "init_ids": _t(kw["init_ids"])} if "init_ids" in kw else kw
    gd, gi, gs = nn_descent(_t(data), k, draws=JaxDraws(key),
                            with_stats=True, **pkw)
    _eq(gi, wi)
    _eq(gd, wd)
    assert gs == ws


def test_build_knn_dispatch_and_recall():
    """``build_knn`` reaches NN-Descent with its draws and stats, and under
    ``"auto"`` drops keyword args the resolved backend does not take;
    ``knn_graph_recall`` equals the reference's definition."""
    n, d, k = 500, 8, 10
    data = _int_data(8, n, d)
    key = jax.random.PRNGKey(9)
    gd, gi, gs = build_knn(_t(data), k, backend="nndescent",
                           draws=JaxDraws(key), with_stats=True, rounds=4)
    wd, wi = jax_nn_descent(jnp.asarray(data), k, key=key, rounds=4,
                            merge_backend="jnp")
    _eq(gi, wi)
    assert gs.backend == "nndescent" and gs.rounds <= 4
    # auto resolves to exact below 8192 rows: NN-Descent's kwargs drop
    ed, ei = build_knn(_t(data), k, backend="auto", rounds=4)
    xd, xi = jax_knn_graph(jnp.asarray(data), k)
    _eq(ed, xd)
    exact = np.array(xi)
    approx = gi.numpy().copy()
    approx[::5, :3] = -1                      # padding never counts
    approx[1::5, 1] = approx[1::5, 0]         # a duplicate counts once
    assert knn_graph_recall(approx, exact) == \
        pytest.approx(jax_knn_graph_recall(approx, exact), abs=0)
    assert knn_graph_recall(exact, exact) == 1.0


def test_nn_descent_default_generator_is_seeded():
    """The port's own draws (``NNDDraws`` over a torch generator): the same
    seed builds the same table, and the table is a real approximation of
    the exact one."""
    data = torch.from_numpy(_int_data(10, 700, 8))
    runs = [nn_descent(data, 10, draws=NNDDraws(
        torch.Generator().manual_seed(1))) for _ in range(2)]
    assert torch.equal(runs[0][1], runs[1][1])
    _, xi = jax_knn_graph(jnp.asarray(data.numpy()), 10)
    assert knn_graph_recall(runs[0][1], np.array(xi)) >= 0.9


def test_nn_descent_on_float_data():
    """Float data: the same ids; distances in the dot form (norms minus
    twice a product summed in another order than XLA's), so each is held
    to 1e-6 of the operands' scale ``|a|^2 + |b|^2``, not of itself."""
    # the shapes of test_nn_descent_equals_reference[defaults]: the
    # reference's jitted steps are compiled once for both
    data = np.random.default_rng(11).standard_normal((600, 12)).astype(
        np.float32)
    key = jax.random.PRNGKey(12)
    wd, wi = jax_nn_descent(jnp.asarray(data), 10, key=key,
                            merge_backend="jnp", block=256)
    gd, gi = nn_descent(_t(data), 10, draws=JaxDraws(key), block=256)
    _eq(gi, wi)
    norms = (data * data).sum(1)
    scale = norms[:, None] + norms[np.asarray(wi)]
    assert (np.abs(gd.numpy() - np.asarray(wd)) <= 1e-6 * scale).all()
