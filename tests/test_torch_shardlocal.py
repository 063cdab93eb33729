"""The port's shard-local derivation (``core/build/shardlocal.py``) and
chunk streaming (``core/build/stream.py``) against the reference's.

Inputs are integer coordinates in [-3, 3] (N = 640, D = 32), made with
numpy from a seed, so every squared distance is an exact small integer in
both packages and the sorted adjacency, the α-scan and the repair's
scatter-min winners are the same by construction: every comparison here
is exact (``assert_array_equal``), ids, round counts and all. The kNN
table is an exact 12-NN by a stable numpy argsort, handed to both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build import DEFAULT_CHUNK as JAX_DEFAULT_CHUNK
from repro.core.build import chunk_spans as jax_chunk_spans
from repro.core.build import derive_local as jax_derive_local
from repro.core.build import repair_local as jax_repair_local
from repro.core.build.prune import reprune as jax_reprune
from repro_torch.core.build import (
    DEFAULT_CHUNK, chunk_spans, derive_local, reachable_mask, repair_local,
    reprune,
)
from repro_torch.core.build.shardlocal import _blocked, _edge_dists

N, D, R = 640, 32, 12


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
def toy():
    rng = np.random.default_rng(5)
    data = rng.integers(-3, 4, size=(N, D)).astype(np.float32)
    d = ((data[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    knn = np.argsort(d, axis=1, kind="stable")[:, :R].astype(np.int32)
    return data, knn


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def test_chunk_spans_cover_like_the_reference():
    for n, c in ((10, 4), (4, 4), (0, 4), (DEFAULT_CHUNK + 1, None),
                 (1023, 1024)):
        assert list(chunk_spans(n, c)) == list(jax_chunk_spans(n, c))
    assert DEFAULT_CHUNK == JAX_DEFAULT_CHUNK == 2048


def test_blocked_and_edge_dists(toy):
    data, knn = toy
    x, ids = _t(data), _t(knn)
    full = _edge_dists(x, ids)
    for blk in (7, 64, 1024):
        np.testing.assert_array_equal(_edge_dists(x, ids, blk=blk).numpy(),
                                      full.numpy())
    want = ((data[:, None, :] - data[knn]) ** 2).sum(-1)
    np.testing.assert_array_equal(full.numpy(), want)
    rows = torch.arange(N)
    out = _blocked(lambda a: a[0] * 2, N, rows, blk=100)
    np.testing.assert_array_equal(out.numpy(), 2 * np.arange(N))


@pytest.mark.parametrize("alpha,degree,blk", [(1.0, 12, 64), (1.1, 6, 64),
                                              (1.3, 8, 1024), (1.2, 4, 7)])
def test_prune_stage_equals_reference_and_reprune(toy, alpha, degree, blk):
    """derive_local(repair=False) == the reference's, == reprune, at a
    block size that leaves a short last block."""
    data, knn = toy
    got = derive_local(_t(data), _t(knn), _t(knn), 0, alpha=alpha,
                       degree=degree, repair=False, blk=blk).numpy()
    want = np.asarray(jax_derive_local(
        _j(data), _j(knn), _j(knn), 0, alpha=alpha, degree=degree,
        repair=False, blk=64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, reprune(_t(data), _t(knn), alpha=alpha, degree=degree).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jax_reprune(_j(data), _j(knn), alpha=alpha,
                                    degree=degree)))


@pytest.mark.parametrize("medoid", [0, 17])
def test_repair_local_equals_reference(toy, medoid):
    """Nodes with no incoming edges: the port's rounds attach them exactly
    as the reference's (same graph, same round count), and every row ends
    reachable from the medoid with at most its degree."""
    data, knn = toy
    nbrs = np.asarray(jax_reprune(_j(data), _j(knn), alpha=1.0, degree=6))
    nbrs = np.where(nbrs >= N - 12, -1, nbrs).astype(np.int32)
    assert not bool(reachable_mask(_t(nbrs), medoid).all())
    got, rounds = repair_local(_t(data), _t(nbrs), _t(knn), medoid)
    want, jrounds = jax_repair_local(_j(data), _j(nbrs), _j(knn), medoid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(jrounds) >= 1
    assert bool(reachable_mask(got, medoid).all())
    assert got.shape == nbrs.shape


def test_repair_local_forced_round_and_cap(toy):
    """Every edge into rows >= 40 cut, and their kNN parents too: those
    rows find no reachable kNN parent and propose the medoid, whose slots
    fill and then get evicted; at max_rounds 1, 2 and 16 the repair stops
    at the same round and graph as the reference's."""
    data, knn = toy
    nbrs = np.asarray(jax_reprune(_j(data), _j(knn), alpha=1.0, degree=2))
    nbrs = np.where(nbrs >= 40, -1, nbrs).astype(np.int32)
    knn_cut = np.where(knn >= 40, -1, knn).astype(np.int32)
    for cap in (1, 2, 16):
        got, rounds = repair_local(_t(data), _t(nbrs), _t(knn_cut), 0,
                                   max_rounds=cap)
        want, jrounds = jax_repair_local(_j(data), _j(nbrs), _j(knn_cut), 0,
                                         max_rounds=cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert rounds == int(jrounds) <= cap


@pytest.mark.parametrize("alpha,degree", [(1.0, 12), (1.2, 8), (1.4, 4)])
def test_derive_local_equals_reference(toy, alpha, degree):
    data, knn = toy
    base = jax_reprune(_j(data), _j(knn), alpha=1.0, degree=R)
    got = derive_local(_t(data), _t(np.asarray(base)), _t(knn), 3,
                       alpha=alpha, degree=degree).numpy()
    want = np.asarray(jax_derive_local(_j(data), base, _j(knn), 3,
                                       alpha=alpha, degree=degree))
    np.testing.assert_array_equal(got, want)
    assert bool(reachable_mask(torch.from_numpy(got), 3).all())


def test_derive_local_padded_rows_inert(toy):
    """Padded (invalid) rows come out edge-less, are never attached and
    never chosen as repair parents — equal to the reference's."""
    data, knn = toy
    pad = 24
    base = np.concatenate([data, np.zeros((pad, D), np.float32)])
    nbrs = np.concatenate([
        np.asarray(jax_reprune(_j(data), _j(knn), alpha=1.0, degree=R)),
        np.full((pad, R), -1, np.int32)])
    knn_p = np.concatenate([knn, np.full((pad, R), -1, np.int32)])
    valid = np.arange(N + pad) < N
    got = derive_local(_t(base), _t(nbrs), _t(knn_p), 0, _t(valid),
                       alpha=1.1, degree=6)
    want = jax_derive_local(_j(base), _j(nbrs), _j(knn_p), 0, _j(valid),
                            alpha=1.1, degree=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out = got.numpy()
    assert (out[N:] == -1).all(), "padded rows grew edges"
    assert (out[:N] < N).all(), "a valid row points at a padded slot"
    assert bool(reachable_mask(got, 0)[:N].all())


def test_derive_local_degree_roundtrip(toy):
    """Chained derivations re-derive from the same structural adjacency:
    the degree can go back up."""
    data, knn = toy
    x, k = _t(data), _t(knn)
    full = derive_local(x, k, k, 0, alpha=1.0, degree=R)
    low = derive_local(x, k, k, 0, alpha=1.0, degree=6)
    again = derive_local(x, k, k, 0, alpha=1.0, degree=R)
    assert low.shape[1] == 6
    np.testing.assert_array_equal(full.numpy(), again.numpy())
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jax_derive_local(_j(data), _j(knn),
                                                  _j(knn), 0, alpha=1.0,
                                                  degree=R)))
