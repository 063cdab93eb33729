"""The device finishing pass against the reference's.

On integer data every distance is exact in f32, so the salted scatter-min
reverse buffer, the interconnect (union through ``topk_pool``, re-prune),
reachability and the batched repair must equal the reference's exactly:
neighbours, repair rounds and protected slots. The graphs carry islands
whose kNN parents are reachable (the cheap path), islands whose kNN
parents are all inside the island (the exact nearest-acceptable
fallback), full rows (evictions, then the authoritative reach check) and
one slot per row (no tree exists: protection is forced until max_rounds).
Reachability must also equal a host BFS.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build.finish import _interconnect_device as jax_interconnect
from repro.core.build.finish import _reverse_buffer as jax_reverse_buffer
from repro.core.build.finish import finish_nsg as jax_finish_nsg
from repro.core.build.finish import propagate_reach as jax_propagate_reach
from repro.core.build.finish import reachable_mask as jax_reachable_mask
from repro.core.build.finish import \
    repair_connectivity_device as jax_repair_device
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro_torch.core.build import finish
from repro_torch.core.build.finish import (
    _interconnect_device, _reverse_buffer, finish_nsg, propagate_reach,
    reachable_from, reachable_mask, repair, repair_connectivity_device,
)
from repro_torch.core.build.prune import nsg_from_neighbors, reprune_nsg

N, D = 400, 8


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


@pytest.fixture(scope="module")
def base():
    data = np.random.default_rng(0).integers(0, 16, (N, D)).astype(
        np.float32)
    d, i = jax_knn_graph(jnp.asarray(data), 10)
    return data, np.array(i), np.array(d)


def _graph(base, kind):
    """(nbrs, knn_ids, medoid) with unreachable parts of the given kind."""
    data, knn, _ = base
    rng = np.random.default_rng({"islands": 1, "orphans": 2, "full": 3,
                                 "one_slot": 4}[kind])
    knn = knn.copy()
    cut = rng.permutation(N)[:60]                 # nodes made unreachable
    medoid = int(np.setdiff1d(np.arange(N), cut)[0])
    if kind == "one_slot":
        nbrs = knn[:, :1].copy()                  # R = 1: rows fill at once
    else:
        nbrs = knn[:, :6].copy()
    if kind == "full":
        # no free slot anywhere: every attach evicts an edge
        nbrs[np.isin(nbrs, cut)] = medoid
    else:
        nbrs[rng.random(nbrs.shape) < 0.3] = -1
        nbrs[np.isin(nbrs, cut)] = -1
    if kind == "orphans":
        # the island's kNN rows point only into the island
        island = cut[:20]
        knn[island] = island[rng.integers(0, 20, (20, knn.shape[1]))]
    return nbrs.astype(np.int32), knn.astype(np.int32), medoid


@pytest.mark.parametrize("slots", [8, 64, 256])    # 8: slot collisions
def test_reverse_buffer_equals_reference(base, slots):
    _, knn, dists = base
    nbrs = knn[:, :6].copy()
    nbrs[np.random.default_rng(5).random(nbrs.shape) < 0.2] = -1
    nd = dists[:, :6]
    want = jax_reverse_buffer(jnp.asarray(nbrs), jnp.asarray(nd), slots)
    got = _reverse_buffer(_t(nbrs), _t(nd), slots)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("rev_cap", [2, 12])
def test_interconnect_equals_reference(base, rev_cap):
    data, knn, _ = base
    nbrs = knn[:, :6].copy()
    nbrs[np.random.default_rng(6).random(nbrs.shape) < 0.2] = -1
    want = jax_interconnect(jnp.asarray(data), jnp.asarray(nbrs), 6, 1.0,
                            128, rev_cap, "jnp")
    got = _interconnect_device(_t(data), _t(nbrs), 6, 1.0, 128, rev_cap)
    _eq(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("kind", ["islands", "orphans", "full", "one_slot"])
def test_reachable_mask_equals_reference_and_bfs(base, kind):
    nbrs, _, medoid = _graph(base, kind)
    got = reachable_mask(_t(nbrs), medoid).numpy()
    _eq(got, jax_reachable_mask(jnp.asarray(nbrs), medoid))
    _eq(got, reachable_from(nbrs, medoid))
    assert not got.all()
    seed = np.zeros(N, bool)
    seed[[medoid, 5, 17]] = True
    _eq(propagate_reach(_t(nbrs), _t(seed)),
        jax_propagate_reach(jnp.asarray(nbrs), jnp.asarray(seed)))


@pytest.mark.parametrize("kind", ["islands", "orphans", "full", "one_slot"])
def test_repair_equals_reference(base, kind, monkeypatch):
    data, _, _ = base
    nbrs, knn, medoid = _graph(base, kind)
    calls = []
    nearest = finish._nearest_acceptable
    monkeypatch.setattr(finish, "_nearest_acceptable",
                        lambda *a: calls.append(1) or nearest(*a))
    wn, wp, wr = jax_repair_device(jnp.asarray(data), jnp.asarray(nbrs),
                                   medoid, jnp.asarray(knn),
                                   return_protected=True)
    gn, gp, gr = repair_connectivity_device(_t(data), _t(nbrs), medoid,
                                            _t(knn), return_protected=True)
    _eq(gn, wn)
    _eq(gp, wp)
    assert gr == wr >= 1
    if kind == "one_slot":
        # out-degree 1 spans no tree: both run to max_rounds, forcing
        # evictions of protected edges on the way
        assert gr == 64
    else:
        assert reachable_from(gn.numpy(), medoid).all()
    assert (nbrs == np.asarray(_t(nbrs))).all()       # input left as is
    if kind == "orphans":
        assert calls                                  # the fallback ran


def test_finish_nsg_and_derivations_on_the_device(base):
    data, knn, _ = base
    nbrs, _, medoid = _graph(base, "islands")
    want, ws = jax_finish_nsg(jnp.asarray(data), jnp.asarray(nbrs), medoid,
                              jnp.asarray(knn), degree=6, chunk=128,
                              backend="auto", merge_backend="jnp")
    got, gs = finish_nsg(_t(data), _t(nbrs), medoid, _t(knn), degree=6,
                         chunk=128)
    _eq(got, want)
    assert (gs.backend, gs.union_width, gs.union_dist_evals,
            gs.repair_rounds) == (ws.backend, ws.union_width,
                                  ws.union_dist_evals, ws.repair_rounds)
    # repair / reprune default to the device pass ("auto")
    r_dev, rounds = repair(_t(data), _t(nbrs), medoid, _t(knn))
    r_want, _ = jax_repair_device(jnp.asarray(data), jnp.asarray(nbrs),
                                  medoid, jnp.asarray(knn))
    _eq(r_dev, r_want)
    g = nsg_from_neighbors(_t(data), _t(nbrs), medoid, knn_ids=_t(knn))
    _eq(g.neighbors, r_want)
    again = reprune_nsg(_t(data), g, alpha=1.0, knn_ids=_t(knn))
    assert reachable_from(again.neighbors.numpy(), medoid).all()
    with pytest.raises(ValueError, match="finish backend"):
        repair(_t(data), _t(nbrs), medoid, _t(knn), backend="gpu")
