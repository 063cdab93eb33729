"""The α-scan (``kernels/alpha_scan``) against the reference's.

The plain version (``ref.alpha_scan_ref``, what the port runs on the CPU)
and the prune functions rewired onto it (``alpha_prune``,
``alpha_prune_mask``, ``reprune``, ``reprune_family``) are held exactly to
the reference's ``_alpha_scan`` / ``alpha_prune`` / ``alpha_prune_mask`` /
``reprune`` / ``reprune_family`` on integer data, where every distance is
exact in both packages. The candidate pools carry -1 pads, the node's own
id, duplicate ids and tied distances; degrees below L, several alphas, a
per-row alpha tensor and an empty block are covered. The CUDA kernel runs
only on the card (``tests/test_torch_cuda.py``); here its dispatch and its
operand checks are held.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core.build import prune as jax_prune
from repro.core.knn_graph import knn_graph as jax_knn_graph
from repro_torch.core.build import prune
from repro_torch.kernels.alpha_scan import alpha_scan, alpha_scan_cuda, \
    alpha_scan_ref

N, D, B, L = 160, 8, 48, 24

jax_alpha_scan = jax.jit(jax_prune._alpha_scan, static_argnums=(4,))


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
def pools():
    """Integer data (coordinates in [-3, 3]: ties and repeated points) and
    B distance-ascending candidate pools: random ids with -1 pads, the
    node itself and duplicates mixed in, sorted stably by exact distance
    (pads last)."""
    rng = np.random.default_rng(0)
    data = rng.integers(-3, 4, (N, D)).astype(np.float32)
    nodes = rng.choice(N, B, replace=False).astype(np.int32)
    ids = rng.integers(0, N, (B, L)).astype(np.int32)
    ids[:, 3] = nodes                                   # self
    ids[:, 5] = ids[:, 1]                               # a duplicate
    ids[rng.random((B, L)) < 0.15] = -1                 # pads
    d = ((data[np.maximum(ids, 0)] - data[nodes][:, None]) ** 2).sum(-1)
    d = np.where(ids >= 0, d, np.inf).astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")
    return (data, nodes, np.take_along_axis(ids, order, 1),
            np.take_along_axis(d, order, 1))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("degree", [4, 10, L])
@pytest.mark.parametrize("alpha", [1.0, 1.2, 1.45])
def test_plain_scan_equals_reference(pools, alpha, degree):
    want_keep, want_mask = jax_alpha_scan(*(jnp.asarray(a) for a in pools),
                                          degree, alpha)
    for scan in (alpha_scan_ref, alpha_scan):     # plain; dispatch (CPU)
        keep, mask = scan(*_t(*pools), degree, alpha)
        assert keep.dtype == torch.int32 and mask.dtype == torch.bool
        _eq(keep, want_keep)
        _eq(mask, want_mask)
    # the kept ids are the candidates at the mask's positions, in order
    ids = pools[2]
    for r in range(B):
        kept = ids[r][np.asarray(want_mask[r])]
        _eq(np.asarray(want_keep[r])[:kept.size], kept)


def test_per_row_alpha_equals_reference_per_alpha(pools):
    """A (B,) alpha tensor scans each row at its own slack: row for row
    the reference's scalar scan at that slack."""
    alphas = np.array([1.0, 1.15, 1.3], np.float32)[np.arange(B) % 3]
    keep, mask = alpha_scan(*_t(*pools), 10, torch.from_numpy(alphas))
    for a in np.unique(alphas):
        rows = np.nonzero(alphas == a)[0]
        sub = [p[rows] for p in pools[1:]]
        wk, wm = jax_alpha_scan(jnp.asarray(pools[0]),
                                *(jnp.asarray(s) for s in sub), 10,
                                float(a))
        _eq(keep[rows], wk)
        _eq(mask[rows], wm)


@pytest.mark.parametrize("degree,alpha", [(6, 1.0), (12, 1.25)])
def test_alpha_prune_and_mask_equal_reference(pools, degree, alpha):
    args = [jnp.asarray(a) for a in pools]
    _eq(prune.alpha_prune(*_t(*pools), degree, alpha),
        jax_prune.alpha_prune(*args, degree, alpha))
    _eq(prune.alpha_prune_mask(*_t(*pools), degree, alpha),
        jax_prune.alpha_prune_mask(*args, degree, alpha))
    # chunked: the same rows, whatever the chunk
    _eq(prune.prune_in_chunks(*_t(*pools), degree, 7, alpha),
        jax_prune.alpha_prune(*args, degree, alpha))


@pytest.fixture(scope="module")
def graph():
    """A kNN adjacency the reference built over integer data."""
    data = np.random.default_rng(1).integers(-3, 4, (300, 8)).astype(
        np.float32)
    _, ids = jax_knn_graph(jnp.asarray(data), 10)
    return data, np.array(ids)


@pytest.mark.parametrize("alpha,degree", [(1.0, 10), (1.2, 6)])
def test_reprune_equals_reference(graph, alpha, degree):
    data, nbrs = graph
    _eq(prune.reprune(*_t(data, nbrs), alpha=alpha, degree=degree,
                      chunk=64),
        jax_prune.reprune(jnp.asarray(data), jnp.asarray(nbrs), alpha=alpha,
                          degree=degree, chunk=64))


@pytest.mark.parametrize("materialize", [True, False])
def test_reprune_family_equals_reference(graph, materialize):
    data, nbrs = graph
    alphas = (1.0, 1.1, 1.3)
    want = jax_prune.reprune_family(jnp.asarray(data), jnp.asarray(nbrs),
                                    alphas, chunk=64,
                                    materialize=materialize)
    got = prune.reprune_family(*_t(data, nbrs), alphas, chunk=64,
                               materialize=materialize)
    if materialize:
        _eq(got, want)
    else:
        _eq(got.masks.numpy().view(np.uint32), want.masks)
        _eq(got.member(2, 4), want.member(2, 4))


def test_empty_block(pools):
    data = torch.from_numpy(pools[0])
    keep, mask = alpha_scan(data, torch.zeros(0, dtype=torch.int32),
                            torch.zeros((0, L), dtype=torch.int32),
                            torch.zeros((0, L)), 8, 1.0)
    assert keep.shape == (0, 8) and mask.shape == (0, L)


def test_cpu_goes_to_the_plain_version_and_cuda_is_demanded(pools):
    before = alpha_scan_cuda.launches
    keep, mask = alpha_scan(*_t(*pools), 8, 1.1)
    want = alpha_scan_ref(*_t(*pools), 8, 1.1)
    assert torch.equal(keep, want[0]) and torch.equal(mask, want[1])
    assert alpha_scan_cuda.launches == before
    with pytest.raises(RuntimeError, match="backend='cuda' needs CUDA"):
        alpha_scan(*_t(*pools), 8, 1.1, backend="cuda")
    with pytest.raises(ValueError, match="unknown alpha_scan backend"):
        alpha_scan(*_t(*pools), 8, 1.1, backend="triton")
    # the kernel's wrapper refuses CPU tensors before it builds anything
    with pytest.raises(ValueError, match="must be on CUDA"):
        alpha_scan_cuda(*_t(*pools), 8, 1.1)
    assert alpha_scan_cuda.launches == before


def test_prune_keeps_no_loop_over_candidate_positions():
    """The occlusion scan is one ``alpha_scan`` call per chunk: prune.py
    steps no candidate position itself."""
    src = inspect.getsource(prune)
    assert "alpha_scan(" in src and "range(L)" not in src
    assert "for j in" not in src
