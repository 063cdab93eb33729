"""The reference's last public functions in the port: ``core.nsg.
mrng_prune``, ``core.pca.dim_for_energy`` and ``core.build.
sorted_adjacency``, each against the reference's on the same inputs made
from a seed with numpy. Integer data keeps every squared distance exact in
both packages, so ids and distances are held exactly; ``dim_for_energy``
returns equal ints."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the reference)
from repro.core import build as jax_build
from repro.core import distances as jax_distances
from repro.core import nsg as jax_nsg
from repro.core import pca as jax_pca
from repro_torch.core import build, distances, nsg, pca
from repro_torch.core.build import prune

N, D = 300, 32


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
def data():
    """Integer rows in [-4, 4]: exact distances, ties and repeated
    points."""
    rng = np.random.default_rng(0)
    return rng.integers(-4, 5, (N, D)).astype(np.float32)


def _pools(data, n, L, seed):
    """n distance-ascending pools of L random ids (the reference's
    ``_sorted_pool`` of ``tests/test_build.py``), sorted stably by exact
    distance in numpy."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(0, n, (n, L)).astype(np.int32)
    d = ((data[cand] - data[:n, None]) ** 2).sum(-1).astype(np.float32)
    order = np.argsort(d, axis=1, kind="stable")
    return (np.take_along_axis(cand, order, 1),
            np.take_along_axis(d, order, 1))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("L,degree", [(24, 12), (32, 16), (32, 8),
                                      (32, 4)])
def test_mrng_prune_equals_reference(data, L, degree):
    """``mrng_prune`` equals the reference's id for id at the shapes of
    its ``test_build.py``, and equals the port's ``alpha_prune`` at
    alpha = 1."""
    cand, cd = _pools(data, N, L, seed=L + degree)
    nodes = np.arange(N, dtype=np.int32)
    want = jax_nsg.mrng_prune(*(jnp.asarray(a) for a in
                                (data, nodes, cand, cd)), degree=degree)
    args = [torch.from_numpy(a) for a in (data, nodes, cand, cd)]
    got = nsg.mrng_prune(*args, degree=degree)
    assert got.dtype == torch.int32 and got.shape == (N, degree)
    _eq(got, want)
    _eq(got, prune.alpha_prune(*args, degree, alpha=1.0))


def test_reprune_at_alpha_one_is_mrng_prune(data):
    """The prefix property of the reference's
    ``test_reprune_alpha1_reproduces_mrng_prefix``: reprune at alpha = 1
    with degree r of the cached degree-16 graph equals ``mrng_prune`` of
    the original pools at r, in both packages, and the two agree."""
    cand, cd = _pools(data, N, 32, seed=6)
    nodes = np.arange(N, dtype=np.int32)
    t = [torch.from_numpy(a) for a in (data, nodes, cand, cd)]
    j = [jnp.asarray(a) for a in (data, nodes, cand, cd)]
    full = nsg.mrng_prune(*t, degree=16)
    _eq(prune.reprune(t[0], full, alpha=1.0, degree=16), full)
    for r in (8, 4):
        direct = nsg.mrng_prune(*t, degree=r)
        _eq(prune.reprune(t[0], full, alpha=1.0, degree=r), direct)
        _eq(direct, jax_nsg.mrng_prune(*j, degree=r))


def test_mrng_prune_fixed_pools_equal_reference():
    """The reference's ``test_core_ann.py`` pools: one id list 1..32 for
    four nodes 40 apart, sorted by distance, degree 8."""
    rng = np.random.default_rng(13)
    data = rng.integers(-3, 4, (64, 8)).astype(np.float32)
    nodes = np.arange(4, dtype=np.int32) * 40 % 64
    cand = np.tile(np.arange(1, 33, dtype=np.int32)[None], (4, 1))
    d = ((data[cand] - data[nodes][:, None]) ** 2).sum(-1)
    order = np.argsort(d, 1, kind="stable")
    cand = np.take_along_axis(cand, order, 1)
    d = np.take_along_axis(d, order, 1).astype(np.float32)
    want = jax_nsg.mrng_prune(*(jnp.asarray(a) for a in
                                (data, nodes, cand, d)), degree=8)
    got = nsg.mrng_prune(*(torch.from_numpy(a) for a in
                           (data, nodes, cand, d)), degree=8)
    _eq(got, want)
    for row, p in zip(got.numpy(), nodes):
        vals = row[row >= 0]
        assert len(np.unique(vals)) == len(vals) and p not in vals


@pytest.mark.parametrize("energy", [0.1, 0.5, 0.75, 0.9, 0.95])
def test_dim_for_energy_equals_reference(energy):
    """The smallest D whose explained share reaches ``energy``: the same
    int as the reference's on decaying-variance rows (its
    ``test_dim_for_energy_monotone`` data, drawn with numpy)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((200, 16)) * 0.7 ** np.arange(16)
         ).astype(np.float32)
    want = jax_pca.dim_for_energy(jnp.asarray(x), energy)
    got = pca.dim_for_energy(torch.from_numpy(x), energy)
    assert isinstance(got, int) and got == want
    assert 1 <= got <= 16


def test_dim_for_energy_is_monotone():
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((300, 24))
                          * 0.8 ** np.arange(24)).astype(np.float32))
    dims = [pca.dim_for_energy(x, e) for e in (0.2, 0.5, 0.8, 0.95)]
    assert dims == sorted(dims) and dims[-1] <= 24


@pytest.mark.parametrize("chunk", [2048, 37])
def test_sorted_adjacency_equals_reference(data, chunk):
    """``sorted_adjacency``: each row's adjacency sorted stably by exact
    distance (-1 slots, +inf, last), ids and distances equal to the
    reference's, a chunk under N included, and equal to the chunked
    form."""
    rng = np.random.default_rng(3)
    nbrs = rng.integers(0, N, (N, 20)).astype(np.int32)
    nbrs[:, 4] = nbrs[:, 0]                             # a duplicate
    nbrs[rng.random((N, 20)) < 0.1] = -1                # pads
    want_i, want_d = jax_build.sorted_adjacency(jnp.asarray(data),
                                                jnp.asarray(nbrs),
                                                chunk=chunk)
    t_data, t_nbrs = torch.from_numpy(data), torch.from_numpy(nbrs)
    got_i, got_d = build.sorted_adjacency(t_data, t_nbrs, chunk=chunk)
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    _eq(got_i, want_i)
    _eq(got_d, want_d)
    ci, cd = prune.sorted_adjacency_chunk(t_data, t_data, t_nbrs)
    _eq(ci, got_i)
    _eq(cd, got_d)


@pytest.mark.parametrize("ref,port,none", [
    (jax_build, build, ()), (jax_nsg, nsg, ()), (jax_pca, pca, ()),
    (jax_distances, distances, ("match_vma",))])
def test_public_functions_have_counterparts(ref, port, none):
    """Every public function and class of the reference's module has a
    counterpart of the same name in the port's (``none``: the names the
    port lists as having none), and ``core.build`` exports the
    reference's ``__all__``."""
    names = {n for n, v in vars(ref).items() if not n.startswith("_")
             and n not in none and callable(v)
             and getattr(v, "__module__", "") == ref.__name__}
    assert names <= set(dir(port)), sorted(names - set(dir(port)))
    if port is distances:
        assert {"l2_topk", "pairwise_sqdist"} <= set(port.__all__)
    if hasattr(ref, "__all__"):
        assert set(ref.__all__) <= set(port.__all__)
