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
