"""The port's batched beam search against the reference's.

Both packages search one graph that the reference built. The reference
runs ``beam_search(layout="batched", hop_backend="staged",
gather_backend="jnp")``, the diff-square arithmetic of the port's
gather_dist kernel and fused hop. On integer-valued data every distance is
exact, so ids, dists, hops, gathered and dup_gathered must match exactly
for every port hop. On float data dists are held to rtol = atol = 1e-5
and ids to >= 99% of rows; there the port's dot-formula gather (the CPU
default) is held to the reference's dot-formula gather (its CPU default,
``gather_backend=None``), since the two forms differ by cancellation.
The port's fused hop must equal its staged hop exactly when the staged hop
runs the gather_dist family.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.beam_search import beam_search as jax_beam_search
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro_torch.core.beam_search import beam_search

# (port keywords, the reference's gather of the same arithmetic form)
PORT_HOPS = [(dict(hop_backend="staged"), None),             # dot formula
             (dict(hop_backend="staged", gather_backend="kernel"), "jnp"),
             (dict(hop_backend="fused"), "jnp")]
HOP_IDS = ["staged-dot", "staged-kernel", "fused"]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def int_graph():
    """Integer-valued data (coordinates in [-3, 3]: many tied distances)
    and a kNN graph the reference built, with -1 padding in some rows."""
    rng = np.random.default_rng(0)
    data = rng.integers(-3, 4, (600, 8)).astype(np.float32)
    _, ids = jax_knn_graph(jnp.asarray(data), 10)
    nbrs = np.array(ids)
    nbrs[::7, 8:] = -1
    queries = rng.integers(-3, 4, (40, 8)).astype(np.float32)
    entry = rng.integers(0, 600, 40).astype(np.int32)
    return data, nbrs, queries, entry


def _both(data, nbrs, queries, entry, mode, port_kw, jax_gather="jnp",
          **kw):
    jd, ji, js = jax_beam_search(
        jnp.asarray(queries), jnp.asarray(data), jnp.asarray(nbrs),
        jnp.asarray(entry), layout="batched", hop_backend="staged",
        gather_backend=jax_gather, mode=mode, with_stats=True, **kw)
    pd, pi, ps = beam_search(
        torch.from_numpy(queries), torch.from_numpy(data),
        torch.from_numpy(nbrs), torch.from_numpy(entry), mode=mode,
        with_stats=True, **port_kw, **kw)
    return (np.asarray(jd), np.asarray(ji), [np.asarray(s) for s in js]), \
        (pd.numpy(), pi.numpy(), [s.numpy() for s in ps])


@pytest.mark.parametrize("hop", PORT_HOPS, ids=HOP_IDS)
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_beam_search_exact_on_integer_data(int_graph, mode, hop):
    data, nbrs, queries, entry = int_graph
    (jd, ji, js), (pd, pi, ps) = _both(data, nbrs, queries, entry, mode,
                                       hop[0], ef=16, k=10)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)
    for got, want in zip(ps, js):          # hops, gathered, dup, wasted
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hop", PORT_HOPS, ids=HOP_IDS)
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_beam_search_float_data(small_nsg, ann_data, mode, hop):
    idx = small_nsg
    q = np.array(idx.project(ann_data["queries"]))
    entry = np.asarray(idx.eps.select(jnp.asarray(q)))
    base = np.array(idx.base)
    nbrs = np.array(idx.graph.neighbors)
    (jd, ji, js), (pd, pi, ps) = _both(base, nbrs, q, entry, mode, hop[0],
                                       hop[1], ef=32, k=10)
    if hop[1] is None:
        # |q|^2 + |x|^2 - 2 q.x cancels: its rounding error is relative to
        # the norms, not to the distance, so the bound is 1e-5 of them
        norms = (q ** 2).sum(1)[:, None] + (base ** 2).sum(1).max()
        assert (np.abs(pd - jd) <= 1e-5 * norms + 1e-5).all()
    else:
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    assert (pi == ji).all(1).mean() >= 0.99
    assert abs(int(ps[0].sum()) - int(js[0].sum())) <= 0.01 * js[0].sum()


@pytest.mark.parametrize("mode", ["while", "fori"])
def test_fused_hop_equals_staged_kernel_hop(small_nsg, ann_data, mode):
    idx = small_nsg
    q = torch.from_numpy(np.asarray(idx.project(ann_data["queries"])))
    entry = torch.from_numpy(np.asarray(idx.eps.select(jnp.asarray(q))))
    base = torch.from_numpy(np.asarray(idx.base))
    nbrs = torch.from_numpy(np.asarray(idx.graph.neighbors))
    kw = dict(ef=32, k=10, mode=mode, with_stats=True)
    fd, fi, fs = beam_search(q, base, nbrs, entry, hop_backend="fused", **kw)
    sd, si, ss = beam_search(q, base, nbrs, entry, hop_backend="staged",
                             gather_backend="kernel", **kw)
    assert torch.equal(fi, si) and torch.equal(fd, sd)
    for a, b in zip(fs, ss):
        assert torch.equal(a, b)


def test_unported_options_raise(int_graph):
    """A patience below 1 or a negative eps is refused, as the reference
    refuses them; a quantized backend without codes and a LUT, or an
    unknown backend, is refused too."""
    data, nbrs, queries, entry = (torch.from_numpy(a) for a in int_graph)
    with pytest.raises(ValueError, match="patience"):
        beam_search(queries, data, nbrs, entry, ef=8, k=4, patience=0)
    with pytest.raises(ValueError, match="eps"):
        beam_search(queries, data, nbrs, entry, ef=8, k=4, patience=2,
                    eps=-1.0)
    with pytest.raises(ValueError, match="codes and lut"):
        beam_search(queries, data, nbrs, entry, ef=8, k=4,
                    dist_backend="pq")
    with pytest.raises(ValueError, match="dist_backend"):
        beam_search(queries, data, nbrs, entry, ef=8, k=4,
                    dist_backend="int4")


# -- the hop loop on the device (``_run_hop_slices`` over ``beam_hops``; its
# plain version on the CPU) against the reference's guarded ``_run_hops``

LOOP_EF, LOOP_K, LOOP_ITERS = 16, 10, 40
PQ_M, PQ_C = 4, 16


def _loop_operands(int_graph, dist_backend):
    """(queries, db, neighbors, entry, codes, lut) as numpy; pq: integer
    codebook LUT entries, so every LUT sum is exact."""
    data, nbrs, queries, entry = int_graph
    if dist_backend == "f32":
        return queries, data, nbrs, entry, None, None
    rng = np.random.default_rng(5)
    codes = rng.integers(0, PQ_C, (data.shape[0], PQ_M)).astype(np.uint8)
    lut = rng.integers(0, 6, (queries.shape[0], PQ_M, PQ_C)).astype(
        np.float32)
    return queries, data, nbrs, entry, codes, lut


def _jax_setup(q, db, nbrs, codes, lut, dist_backend):
    from repro.core.beam_search import _batched_hop_setup
    return _batched_hop_setup(
        q, db, nbrs, gather_dist=None, gather_backend="jnp",
        dist_backend=dist_backend, codes=codes, lut=lut, hop_backend="staged")


@functools.partial(jax.jit, static_argnames=("dist_backend",))
def _jax_seed(q, db, nbrs, entry, codes, lut, *, dist_backend):
    from repro.core.beam_search import _seed_batched
    gd, _ = _jax_setup(q, db, nbrs, codes, lut, dist_backend)
    return _seed_batched(q, db, nbrs, entry, LOOP_EF, gd)


@functools.partial(jax.jit, static_argnames=("dist_backend", "mode",
                                             "patience"))
def _jax_run(state, q, db, nbrs, codes, lut, *, dist_backend, mode,
             patience):
    from repro.core.beam_search import _run_hops
    _, body = _jax_setup(q, db, nbrs, codes, lut, dist_backend)
    return _run_hops(state, body, k=LOOP_K, max_iters=LOOP_ITERS, mode=mode,
                     patience=patience, eps=0.0)


def _as_jax(a):
    return None if a is None else jnp.asarray(a)


def _as_torch(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _stuck_lane(state):
    """Lane 0: its one unvisited valid entry sits at +inf behind a visited
    slot 0, so its frontier select takes slot 0 and the lane idles."""
    pool_i, pool_d, pool_v = (np.array(a) for a in state[:3])
    pool_i[0, :3] = [5, 7, -1]
    pool_d[0, :3] = [3.0, np.inf, np.inf]
    pool_v[0, :3] = [True, False, False]
    return (pool_i, pool_d, pool_v) + tuple(np.array(a) for a in state[3:])


def _loop_case(int_graph, dist_backend, mode, patience, stuck=False):
    q, db, nbrs, entry, codes, lut = _loop_operands(int_graph, dist_backend)
    ops = dict(q=_as_jax(q), db=_as_jax(db), nbrs=_as_jax(nbrs),
               codes=_as_jax(codes), lut=_as_jax(lut))
    state = _jax_seed(entry=jnp.asarray(entry), dist_backend=dist_backend,
                      **ops)
    if stuck:
        state = tuple(jnp.asarray(a) for a in _stuck_lane(state))
    want = _jax_run(state, dist_backend=dist_backend, mode=mode,
                    patience=patience, **ops)
    q_or_lut, table = (q, db) if dist_backend == "f32" else (lut, codes)
    return ([_as_torch(a) for a in state], _as_torch(q_or_lut),
            _as_torch(table), torch.from_numpy(nbrs),
            [np.asarray(a) for a in want])


LOOP_FIELDS = ("ids", "dists", "visited", "hops", "gathered",
               "dup_gathered", "wasted", "stale")


@pytest.mark.parametrize("max_steps", [1, 7, LOOP_ITERS])
@pytest.mark.parametrize("patience", [None, 2])
@pytest.mark.parametrize("mode", ["while", "fori"])
@pytest.mark.parametrize("dist_backend", ["f32", "pq"])
def test_hop_loop_slices_equal_the_reference_loop(int_graph, dist_backend,
                                                  mode, patience, max_steps):
    """Every field of the loop state, exactly, after the whole loop run in
    slices of ``max_steps`` (the kernel's unit on the card) against the
    reference's loop run in one piece."""
    from repro_torch.core.beam_search import _run_hop_slices
    state, q_or_lut, table, nbrs, want = _loop_case(
        int_graph, dist_backend, mode, patience)
    got = _run_hop_slices(tuple(state), q_or_lut, table, nbrs, dist_backend,
                          k=LOOP_K, max_iters=LOOP_ITERS, mode=mode,
                          patience=patience, eps=0.0, max_steps=max_steps)
    for name, g, w in zip(LOOP_FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[3].sum()) > 0                  # the lanes did hop


@pytest.mark.parametrize("mode,patience", [("fori", None), ("while", 3)])
@pytest.mark.parametrize("dist_backend", ["f32", "pq"])
def test_hop_loop_lane_stuck_at_inf(int_graph, dist_backend, mode, patience):
    """A lane whose unvisited entries all sit at +inf stays live without
    hopping (its frontier is a visited slot); it ends at max_iters steps or
    by patience, as in the reference."""
    from repro_torch.core.beam_search import _run_hop_slices
    state, q_or_lut, table, nbrs, want = _loop_case(
        int_graph, dist_backend, mode, patience, stuck=True)
    got = _run_hop_slices(tuple(state), q_or_lut, table, nbrs, dist_backend,
                          k=LOOP_K, max_iters=LOOP_ITERS, mode=mode,
                          patience=patience, eps=0.0, max_steps=7)
    for name, g, w in zip(LOOP_FIELDS, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[3][0]) == 0 and bool(got[2][0, 0])


def test_beam_hops_ref_counts_iterations_and_the_live_test(int_graph):
    """One slice of the plain loop: ``iters`` counts the hops each lane ran
    (a prefix of the slice), and ``live`` is the live test after them."""
    from repro_torch.kernels.beam_hop import beam_hops_ref, lane_live
    state, q, db, nbrs, _ = _loop_case(int_graph, "f32", "while", None)
    pool_i, pool_d, pool_v, hops, gath, dup, _, stale = state
    out = beam_hops_ref(nbrs, pool_i, pool_d, pool_v, hops, gath, dup, stale,
                        q, db, k=LOOP_K, max_iters=LOOP_ITERS, max_steps=5)
    iters, live = out[7], out[8]
    assert int(iters.max()) == 5 and int(iters.min()) >= 1
    assert torch.equal(out[3], hops + iters)    # every hop here was active
    assert torch.equal(live, lane_live(out[0], out[2], out[3], out[6],
                                       max_iters=LOOP_ITERS, patience=None))
    assert not bool((live & (iters < 5)).any())
