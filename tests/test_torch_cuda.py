"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.) Integer-valued
inputs must match exactly; float inputs to rtol = atol = 1e-5, with the
hop's ids equal on >= 99% of rows (a near-tie may order differently when
two reductions round differently).
"""
import pytest
import torch

from repro_torch.core.beam_search import beam_search
from repro_torch.core.knn_graph import knn_graph
from repro_torch.kernels.beam_hop import beam_hop_cuda, beam_hop_ref
from repro_torch.kernels.gather_dist import gather_dist_cuda, gather_dist_ref
from repro_torch.kernels.topk_merge import (
    topk_merge, topk_merge_cuda, topk_merge_ref, topk_pool_ref,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")
    return torch.device("cuda")


def _vectors(g, shape, kind, dev):
    if kind == "int":
        return torch.randint(-8, 9, shape, generator=g).float().to(dev)
    return torch.randn(shape, generator=g).to(dev)


def _ids(g, shape, n, dev):
    return torch.randint(-1, n, shape, generator=g,
                         dtype=torch.int32).to(dev)


def _close(got, want, kind):
    if kind == "int" or got.dtype != torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("d", [600, 37])          # float4 rows / scalar rows
def test_gather_dist_kernel(dev, kind, d):
    g = torch.Generator().manual_seed(d)
    q, db = _vectors(g, (64, d), kind, dev), _vectors(g, (5000, d), kind, dev)
    ids = _ids(g, (64, 32), 5000, dev)
    _close(gather_dist_cuda(q, db, ids), gather_dist_ref(q, db, ids), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
def test_beam_hop_kernel(dev, kind):
    g = torch.Generator().manual_seed(1)
    nq, n, d, r, ef = 256, 4000, 600, 32, 64
    db, q = _vectors(g, (n, d), kind, dev), _vectors(g, (nq, d), kind, dev)
    nbrs = _ids(g, (n, r), n, dev)
    pool_i = _ids(g, (nq, ef), n, dev)
    pool_d = torch.where(pool_i >= 0, torch.randint(
        0, 30000, (nq, ef), generator=g).float().to(dev), float("inf"))
    pool_d = pool_d.sort(1).values
    pool_v = (torch.rand((nq, ef), generator=g) < 0.4).to(dev)
    sel = _ids(g, (nq,), n, dev)
    live = sel >= 0
    nbrs[sel[live].long(), :6] = pool_i[live, :6]     # pool duplicates
    args = (sel, nbrs, pool_i, pool_d, pool_v, q, db)
    got, want = beam_hop_cuda(*args), beam_hop_ref(*args)
    assert torch.equal(got[3], want[3])               # stats
    if kind == "int":
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
        assert (got[0] == want[0]).all(1).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(96, 64), (19, 8), (300, 100)])
def test_topk_kernel_both_modes(dev, m, k):
    g = torch.Generator().manual_seed(m)
    ids = _ids(g, (512, m), 2 * m, dev)
    table = torch.randint(0, 6, (512, 2 * m), generator=g).float().to(dev)
    ds = torch.where(ids >= 0, table.gather(1, ids.clamp_min(0).long()),
                     float("inf"))
    gi, gd, _ = topk_merge_cuda(ids, ds, None, k, merge=False)
    wi, wd = topk_pool_ref(ids, ds, k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    fresh = (torch.rand((512, m), generator=g) < 0.5).to(dev) & (ids >= 0)
    h = m // 3
    merged = (ids[:, :h], ds[:, :h], fresh[:, :h], ids[:, h:], ds[:, h:],
              min(k, m))
    for a, b in zip(topk_merge(*merged), topk_merge_ref(*merged)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_fused_hop_equals_staged_hop_on_the_card(dev, mode):
    g = torch.Generator().manual_seed(7)
    data = torch.randn((3000, 600), generator=g).to(dev)
    _, nbrs = knn_graph(data, 16)
    q = data[:128] + 0.05 * torch.randn((128, 600), generator=g).to(dev)
    entry = torch.zeros(128, dtype=torch.int32, device=dev)
    kw = dict(ef=32, k=10, mode=mode, with_stats=True)
    fd, fi, fs = beam_search(q, data, nbrs, entry, hop_backend="fused", **kw)
    sd, si, ss = beam_search(q, data, nbrs, entry, hop_backend="staged", **kw)
    assert torch.equal(fd, sd) and torch.equal(fi, si)
    for a, b in zip(fs, ss):
        assert torch.equal(a, b)
