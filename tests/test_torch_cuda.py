"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA card. The
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.) Integer-valued
inputs must match exactly; float inputs to rtol = atol = 1e-5, with the
hop's ids equal on >= 99% of rows (a near-tie may order differently when
two reductions round differently). The LUT kernels (``lut_dist`` and
``beam_hop`` in LUT mode) add in the plain version's order, so they must
match exactly on float inputs too. ``l2topk`` sums its dot products in
another order than cuBLAS: float inputs give dists to rtol 1e-5 and ids on
>= 99% of rows; integer inputs, ties included, match exactly.
"""
import pytest
import torch

from repro_torch.core.beam_search import beam_search
from repro_torch.core.knn_graph import knn_graph
from repro_torch.kernels.beam_hop import beam_hop_cuda, beam_hop_lut_cuda, \
    beam_hop_ref
from repro_torch.kernels.gather_dist import gather_dist_cuda, gather_dist_ref
from repro_torch.kernels.lut_dist import lut_dist_cuda, lut_dist_ref
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


def _topk_rows(g, b, m, kind, dev):
    """(B, M) candidate rows with the edges in their first rows: all -1;
    one id repeated (distinct dists, then all tied); ids tied in distance
    across ids; then random rows whose ids repeat and carry one distance
    per id per row (pool assembly) or not (merge). B = 517 is not a
    multiple of the warp variant's 8 rows per block."""
    ids = torch.randint(-1, max(2 * m // 3, 2), (b, m), generator=g,
                        dtype=torch.int32)
    span = 6 if kind == "int" else 1000
    table = torch.randint(0, span, (b, 2 * m + 2), generator=g).float()
    if kind == "float":
        table = table / 7.0
    ds = torch.where(ids >= 0, table.gather(1, ids.clamp_min(0).long()),
                     float("inf"))
    ids[0] = -1
    ds[0] = float("inf")
    ids[1] = 5
    ds[1] = torch.arange(m, 0, -1).float()
    ids[2] = 7
    ds[2] = 3.0
    ids[3] = torch.arange(m, dtype=torch.int32)
    ds[3] = 1.0
    return ids.to(dev), ds.to(dev)


TOPK_WIDTHS = [(1, 1), (20, 20), (32, 7), (64, 64), (96, 64), (116, 32),
               (256, 100), (300, 100), (2048, 64)]  # p = 32 ... 2048


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("m,k", TOPK_WIDTHS)
def test_topk_pool_variants_equal_the_plain_version(dev, m, k, variant,
                                                   kind):
    from repro_torch.kernels.topk_merge.topk_merge import WARP_MAX_SORT
    if variant == "warp" and m > WARP_MAX_SORT:
        with pytest.raises(ValueError, match="warp variant"):
            topk_merge_cuda(*_topk_rows(torch.Generator(), 4, m, kind, dev),
                            None, k, merge=False, variant=variant)
        return
    g = torch.Generator().manual_seed(m * 10 + k)
    ids, ds = _topk_rows(g, 517, m, kind, dev)
    want = topk_pool_ref(ids, ds, k)
    n0 = dict(topk_merge_cuda.by_variant)
    gi, gd, _ = topk_merge_cuda(ids, ds, None, k, merge=False,
                                variant=variant)
    assert torch.equal(gi, want[0]) and torch.equal(gd, want[1])
    assert {v: topk_merge_cuda.by_variant[v] - n0[v] for v in n0} == \
        {v: int(v == variant) for v in n0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("m,k", TOPK_WIDTHS)
def test_topk_merge_variants_equal_the_plain_version(dev, m, k, variant,
                                                    kind):
    """Merge mode with any fresh pattern (the whole row as the current
    table, no candidates), and fresh and old copies of one id."""
    from repro_torch.kernels.topk_merge.topk_merge import WARP_MAX_SORT
    if variant == "warp" and m > WARP_MAX_SORT:
        return                     # refused: the pool test checks it
    g = torch.Generator().manual_seed(m * 10 + k + 1)
    ids, ds = _topk_rows(g, 517, m, kind, dev)
    fresh = (torch.rand((517, m), generator=g) < 0.5).to(dev)
    fresh[2, ::2] = True           # one id, fresh and old copies alike
    fresh[2, 1::2] = False
    empty_i, empty_d = ids[:, :0], ds[:, :0]
    want = topk_merge_ref(ids, ds, fresh, empty_i, empty_d, k)
    n0 = topk_merge_cuda.by_variant[variant]
    got = topk_merge_cuda(ids, ds, fresh, k, merge=True, variant=variant)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert topk_merge_cuda.by_variant[variant] == n0 + 1
    if m >= 3:                     # the dispatcher's table + candidates
        h = m // 3
        merged = (ids[:, :h], ds[:, :h], fresh[:, :h], ids[:, h:],
                  ds[:, h:], k)
        for a, b in zip(topk_merge(*merged), topk_merge_ref(*merged)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_topk_empty_batch_launches_nothing(dev):
    ids = torch.zeros((0, 96), dtype=torch.int32, device=dev)
    n0 = topk_merge_cuda.launches
    out = topk_merge_cuda(ids, ids.float(), None, 64, merge=False)
    assert [t.shape for t in out] == [(0, 64)] * 3
    assert topk_merge_cuda.launches == n0


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


def _lut(g, shape, kind, dev):
    if kind == "int":
        return torch.randint(0, 5, shape, generator=g).float().to(dev)
    return (torch.rand(shape, generator=g) * 10).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("m,c", [(300, 256), (600, 256), (37, 256),
                                 (8, 16)])       # uchar4 rows / byte rows
def test_lut_dist_kernel_bit_exact(dev, kind, m, c):
    g = torch.Generator().manual_seed(m + c)
    lut = _lut(g, (64, m, c), kind, dev)
    codes = torch.randint(0, 256, (5000, m), generator=g,
                          dtype=torch.uint8).to(dev)   # > C - 1 when C < 256
    ids = _ids(g, (64, 32), 5000, dev)
    got = lut_dist_cuda(lut, codes, ids)
    assert torch.equal(got, lut_dist_ref(lut, codes, ids))
    assert bool(torch.isinf(got[ids < 0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("r", [1, 32])
@pytest.mark.parametrize("c", [1, 16, 256])
@pytest.mark.parametrize("m", [1, 3, 7, 300, 600, 2100])
@pytest.mark.parametrize("variant", ["thread", "warp"])
def test_lut_dist_variants_bit_exact(dev, variant, m, c, r, aligned):
    """Each variant on float LUTs (the sum's order shows in the bits):
    codes over all of 0..255 (above C - 1 they take the clamp), -1 and
    out-of-range ids, code rows one byte off alignment (read byte by
    byte), M = 2100 over the warp variant's 1,024-entry chunks."""
    g = torch.Generator().manual_seed(m * 7 + c + r)
    n, q = 700, 40
    lut = _lut(g, (q, m, c), "float", dev)
    raw = torch.randint(0, 256, (n * m + 1,), generator=g,
                        dtype=torch.uint8).to(dev)
    codes = (raw[:n * m] if aligned else raw[1:]).view(n, m)
    ids = torch.randint(-1, n + 30, (q, r), generator=g,
                        dtype=torch.int32).to(dev)
    ids[0] = -1
    n0 = dict(lut_dist_cuda.by_variant)
    got = lut_dist_cuda(lut, codes, ids, variant=variant)
    assert torch.equal(got, lut_dist_ref(lut, codes, ids.clamp_max(n - 1)))
    assert bool(torch.isinf(got[ids < 0]).all())
    assert {v: lut_dist_cuda.by_variant[v] - n0[v] for v in n0} == \
        {v: int(v == variant) for v in n0}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("side", [0, 1])
def test_lut_dist_route_sides_of_the_crossover(dev, kind, side):
    """WARP_MAX_PAIRS pairs take the warp variant, one more the thread
    variant; both give the plain version's bits."""
    from repro_torch.kernels.lut_dist.lut_dist import WARP_MAX_PAIRS, route
    pairs = WARP_MAX_PAIRS + side
    want_variant = route(pairs)
    assert want_variant == ("thread" if side else "warp")
    g = torch.Generator().manual_seed(11 + side)
    lut = _lut(g, (pairs, 12, 256), kind, dev)
    codes = torch.randint(0, 256, (3000, 12), generator=g,
                          dtype=torch.uint8).to(dev)
    ids = _ids(g, (pairs, 1), 3000, dev)
    n0 = dict(lut_dist_cuda.by_variant)
    got = lut_dist_cuda(lut, codes, ids)
    assert torch.equal(got, lut_dist_ref(lut, codes, ids))
    assert {v: lut_dist_cuda.by_variant[v] - n0[v] for v in n0} == \
        {v: int(v == want_variant) for v in n0}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["thread", "warp"])
def test_lut_dist_empty_batch_launches_nothing(dev, variant):
    lut = torch.zeros((0, 300, 256), device=dev)
    codes = torch.zeros((10, 300), dtype=torch.uint8, device=dev)
    ids = torch.zeros((0, 1), dtype=torch.int32, device=dev)
    n0 = lut_dist_cuda.launches
    assert lut_dist_cuda(lut, codes, ids, variant=variant).shape == (0, 1)
    assert lut_dist_cuda.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("m", [300, 600])
def test_beam_hop_lut_kernel_bit_exact(dev, kind, m):
    g = torch.Generator().manual_seed(m)
    nq, n, r, ef = 256, 4000, 32, 64
    lut = _lut(g, (nq, m, 256), kind, dev)
    codes = torch.randint(0, 256, (n, m), generator=g,
                          dtype=torch.uint8).to(dev)
    nbrs = _ids(g, (n, r), n, dev)
    pool_i = _ids(g, (nq, ef), n, dev)
    pool_d = torch.where(pool_i >= 0, torch.randint(
        0, 5 * m, (nq, ef), generator=g).float().to(dev), float("inf"))
    pool_d = pool_d.sort(1).values
    pool_v = (torch.rand((nq, ef), generator=g) < 0.4).to(dev)
    sel = _ids(g, (nq,), n, dev)
    live = sel >= 0
    nbrs[sel[live].long(), :6] = pool_i[live, :6]     # pool duplicates
    args = (sel, nbrs, pool_i, pool_d, pool_v, lut, codes)
    got = beam_hop_lut_cuda(*args)
    want = beam_hop_ref(*args, dist_backend="pq")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pq", "int8"])
def test_quantized_fused_hop_equals_staged_hop_on_the_card(dev, backend):
    from repro_torch.core.quant import make_codec
    g = torch.Generator().manual_seed(11)
    data = torch.randn((3000, 64), generator=g).to(dev)
    _, nbrs = knn_graph(data, 16)
    q = data[:128] + 0.05 * torch.randn((128, 64), generator=g).to(dev)
    codec = make_codec(backend, 64).fit(data)
    codes = codec.encode(data)
    entry = torch.zeros(128, dtype=torch.int32, device=dev)
    kw = dict(ef=32, k=10, with_stats=True, dist_backend=backend,
              codes=codes, lut=codec.lut(q))
    fd, fi, fs = beam_search(q, data, nbrs, entry, hop_backend="fused", **kw)
    sd, si, ss = beam_search(q, data, nbrs, entry, hop_backend="staged", **kw)
    assert torch.equal(fd, sd) and torch.equal(fi, si)
    for a, b in zip(fs, ss):
        assert torch.equal(a, b)


# (Q, N, D, k): the main path's widths cut in N, k = 1 / 33 / 128, D = 2
# (PQ's sub-spaces), Q = 1 (the medoid, split over many blocks), N not a
# multiple of the 128-row tile, Q not a multiple of the 64-query tile
L2TOPK_SHAPES = [(300, 5000, 600, 33), (1, 20000, 600, 1), (1000, 3000, 2, 1),
                 (130, 4097, 768, 11), (77, 1000, 64, 128), (5, 3, 16, 9),
                 (2000, 256, 600, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("q,n,d,k", L2TOPK_SHAPES)
def test_l2topk_kernel(dev, kind, q, n, d, k):
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    g = torch.Generator().manual_seed(q + n + d + k)
    if kind == "int":      # coordinates in [-1, 1]: many exact ties
        x = torch.randint(-1, 2, (n, d), generator=g).float().to(dev)
        qs = torch.randint(-1, 2, (q, d), generator=g).float().to(dev)
    else:
        x, qs = _vectors(g, (n, d), kind, dev), _vectors(g, (q, d), kind, dev)
    gd, gi = l2topk_cuda(qs, x, k)
    wd, wi = l2_topk_ref(qs, x, k)
    assert gi.shape == (q, min(k, n)) and gi.dtype == torch.int32
    if kind == "int":
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
    else:
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
        assert (gi == wi).all(1).float().mean() >= 0.99


# (Q, N, D, k) on both sides of every routing boundary, and the variant
# each must take: the small database (N <= 256, D <= 8, k <= 16), the tensor
# cores (Q >= 128, N >= 1024, D >= 32, k <= 64; 4 stages up to k = 33, 3
# above), and the tile variant for the rest; D = 36 is a multiple of 4, not
# of 8 (nor of the 16-column stage), 37 and 6 of neither
L2TOPK_ROUTES = [
    ((1000, 256, 2, 1), "small"), ((1000, 300, 2, 1), "tile"),
    ((1000, 64, 2, 1), "small"), ((500, 256, 6, 16), "small"),
    ((500, 256, 2, 17), "tile"), ((700, 256, 9, 5), "tile"),
    ((300, 5000, 600, 33), "tc"), ((300, 5000, 36, 11), "tc"),
    ((300, 5000, 37, 34), "tc"),
    ((1, 20000, 600, 1), "tile"), ((2000, 64, 600, 1), "tile"),
    ((256, 3000, 600, 64), "tc"), ((256, 3000, 600, 65), "tile"),
    ((77, 1000, 64, 128), "tile"), ((127, 3000, 600, 10), "tile"),
    ((128, 1024, 32, 10), "tc"), ((128, 1023, 32, 10), "tile"),
    ((128, 1024, 31, 10), "tile")]


def _l2topk_inputs(g, q, n, d, kind, dev):
    if kind == "int":      # coordinates in [-1, 1]: many exact ties
        return (torch.randint(-1, 2, (q, d), generator=g).float().to(dev),
                torch.randint(-1, 2, (n, d), generator=g).float().to(dev))
    return _vectors(g, (q, d), kind, dev), _vectors(g, (n, d), kind, dev)


def _l2topk_agrees(got, want, kind):
    (gd, gi), (wd, wi) = got, want
    assert gi.shape == wi.shape and gi.dtype == torch.int32
    if kind == "int":
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
    else:
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
        assert (gi == wi).all(1).float().mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shape,variant", L2TOPK_ROUTES,
                         ids=[f"{v}-{q}x{n}x{d}-k{k}"
                              for (q, n, d, k), v in L2TOPK_ROUTES])
def test_l2topk_routes_each_shape_to_its_variant(dev, kind, shape, variant):
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    from repro_torch.kernels.l2topk.l2topk import variant_for
    q, n, d, k = shape
    assert variant_for(q, n, d, min(k, n)) == variant
    g = torch.Generator().manual_seed(q + n + d + k)
    qs, x = _l2topk_inputs(g, q, n, d, kind, dev)
    before = dict(l2topk_cuda.by_variant)
    got = l2topk_cuda(qs, x, k)
    after = l2topk_cuda.by_variant
    assert after[variant] > before[variant]
    assert all(after[v] == before[v] for v in after if v != variant)
    _l2topk_agrees(got, l2_topk_ref(qs, x, k), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shape", [(5, 3, 16, 3), (1, 700, 40, 7),
                                   (70, 2000, 100, 64), (3, 40, 2, 1)])
def test_l2topk_tc_variant_forced_on_ragged_shapes(dev, kind, shape):
    """The tensor-core variant on shapes its route never gives it: boxes
    past the last query and row, one stage of columns, one query."""
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    q, n, d, k = shape
    g = torch.Generator().manual_seed(q * n + d)
    qs, x = _l2topk_inputs(g, q, n, d, kind, dev)
    before = l2topk_cuda.by_variant["tc"]
    got = l2topk_cuda(qs, x, k, variant="tc")
    assert l2topk_cuda.by_variant["tc"] > before
    _l2topk_agrees(got, l2_topk_ref(qs, x, k), kind)


@pytest.mark.cuda
def test_l2topk_forced_variant_must_take_the_shape(dev):
    from repro_torch.kernels.l2topk import l2topk_cuda
    x = torch.zeros((500, 8), device=dev)
    with pytest.raises(ValueError, match="small variant"):
        l2topk_cuda(x[:4], x, 3, variant="small")
    with pytest.raises(ValueError, match="tc variant"):
        l2topk_cuda(x[:4], x, 65, variant="tc")

    with pytest.raises(ValueError, match="unknown variant"):
        l2topk_cuda(x[:4], x, 3, variant="mma")


@pytest.mark.cuda
def test_l2topk_kernel_refuses_k_over_128(dev):
    """Only the wide variant takes k > 128: forcing tile, tc or small
    there raises, and the route sends such k to wide (no fallback)."""
    from repro_torch.core.distances import l2_topk
    from repro_torch.kernels.l2topk import l2topk_cuda
    x = torch.zeros((500, 8), device=dev)
    for variant in ("tile", "tc", "small"):
        with pytest.raises(ValueError, match=f"{variant} variant"):
            l2topk_cuda(x[:4], x, 129, variant=variant)
    before = l2topk_cuda.by_variant["wide"]
    assert l2_topk(x[:4], x, 200)[1].shape == (4, 200)
    assert l2topk_cuda.by_variant["wide"] > before
    # k is cut to N first: 129 over 100 rows is a tile call
    before = dict(l2topk_cuda.by_variant)
    assert l2topk_cuda(x[:4], x[:100], 129)[1].shape == (4, 100)
    assert l2topk_cuda.by_variant["tile"] > before["tile"]
    assert l2topk_cuda.by_variant["wide"] == before["wide"]


def _l2topk_wide_agrees(got, want, qs, x, kind):
    """At wide k a float near-tie inside the list is likely, and the two
    sums round differently, so on float data the ids are held by what they
    are: unique per row, each one's own distance (recomputed by the plain
    formula) within rtol 1e-5 of the distance returned beside it, and the
    ascending dists within rtol 1e-5 of the plain version's. Integer data:
    exact, ties included."""
    from repro_torch.kernels.l2topk.ref import pairwise_sqdist
    (gd, gi), (wd, wi) = got, want
    assert gi.shape == wi.shape and gi.dtype == torch.int32
    if kind == "int":
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
        return
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    srt = torch.sort(gi, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())
    own = pairwise_sqdist(qs[:, None, :], x[gi.long()]).squeeze(1)
    torch.testing.assert_close(own, gd, rtol=1e-5, atol=1e-5)


# (Q, N, D) for the wide variant: N not a multiple of the 128-row tile,
# one query split over the whole card, a query tile past its last row
WIDE_SHAPES = [(70, 3001, 64), (1, 20000, 600), (130, 1500, 37)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("q,n,d", WIDE_SHAPES)
@pytest.mark.parametrize("k", [129, 256, 1000, None])       # None: k = N
def test_l2topk_wide_variant_equals_the_plain_version(dev, kind, q, n, d,
                                                      k):
    """k > 128 routes to wide, one norms pass, the kernel and (split) the
    merge, all counted under wide; ids and dist bits equal the plain
    version's on tied integer data, dists to rtol 1e-5 on float data."""
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    from repro_torch.kernels.l2topk.l2topk import route
    k = n if k is None else k
    g = torch.Generator().manual_seed(q + n + d + k)
    qs, x = _l2topk_inputs(g, q, n, d, kind, dev)
    before = dict(l2topk_cuda.by_variant)
    got = l2topk_cuda(qs, x, k)
    plan = route(q, n, d, k, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.variant == "wide"
    assert {v: c - before[v] for v, c in l2topk_cuda.by_variant.items()} \
        == {v: (3 if plan.splits > 1 else 2) if v == "wide" else 0
            for v in before}
    _l2topk_wide_agrees(got, l2_topk_ref(qs, x, k), qs, x, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shape", [(5, 3, 16, 3), (77, 1000, 64, 10),
                                   (300, 5000, 600, 33), (1, 700, 8, 128)])
def test_l2topk_wide_variant_forced_at_small_k(dev, kind, shape):
    from repro_torch.kernels.l2topk import l2_topk_ref, l2topk_cuda
    q, n, d, k = shape
    g = torch.Generator().manual_seed(q * n + d + k)
    qs, x = _l2topk_inputs(g, q, n, d, kind, dev)
    before = l2topk_cuda.by_variant["wide"]
    got = l2topk_cuda(qs, x, k, variant="wide")
    assert l2topk_cuda.by_variant["wide"] > before
    _l2topk_wide_agrees(got, l2_topk_ref(qs, x, k), qs, x, kind)


@pytest.mark.cuda
def test_flat_index_search_at_wide_k_on_the_card(dev):
    from repro_torch.core.flat import FlatIndex
    from repro_torch.kernels.l2topk import l2topk_cuda
    g = torch.Generator().manual_seed(21)
    data = torch.randint(-2, 3, (6000, 48), generator=g).float()
    q = torch.randint(-2, 3, (40, 48), generator=g).float()
    before = l2topk_cuda.by_variant["wide"]
    gd, gi = FlatIndex(data.to(dev)).search(q.to(dev), 200)
    assert l2topk_cuda.by_variant["wide"] > before
    wd, wi = FlatIndex(data).search(q, 200)
    assert gi.shape == (40, 200)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gd.cpu(), wd)


@pytest.mark.cuda
def test_ann_objective_counters_on_the_card_equal_the_cpu_run(dev):
    from repro_torch.core.pipeline import IndexParams, structural_build_count
    from repro_torch.core.tuning import AnnObjective
    g = torch.Generator().manual_seed(3)
    data = torch.randn((800, 16), generator=g)
    queries = data[:40] + 0.05 * torch.randn((40, 16), generator=g)
    base = IndexParams(pca_dim=16, graph_degree=8, build_knn_k=8,
                       build_candidates=16, ef_search=32, knn_backend="exact",
                       finish_backend="host")
    trials = [dict(antihub_keep=0.9, graph_degree=8, alpha=1.0, ep_clusters=4,
                   hop_backend="fused"),
              dict(antihub_keep=0.9, graph_degree=6, alpha=1.12,
                   ep_clusters=4, patience=3),
              dict(antihub_keep=0.8, pca_dim=12, graph_degree=5, alpha=1.3,
                   ep_clusters=2, hop_backend="staged"),
              dict(antihub_keep=0.9, graph_degree=6, alpha=1.08,
                   ep_clusters=8)]
    runs = []
    for device in ("cpu", dev):
        obj = AnnObjective(data, queries, k=10, base_params=base,
                           qps_repeats=1, device=device)
        c0 = structural_build_count()
        deltas = [(obj.evaluate(p), structural_build_count() - c0)[1]
                  for p in trials]
        runs.append((obj, deltas))
    (cpu, cpu_deltas), (card, card_deltas) = runs
    assert card_deltas == cpu_deltas == [1, 1, 2, 2]
    assert (card.family_prunes, card.grid_hits) == \
        (cpu.family_prunes, cpu.grid_hits) == (2, 3)
    for (cp, cr), (gp, gr) in zip(cpu.eval_log, card.eval_log):
        assert cp == gp
        assert (cr.cached_build, cr.repruned) == (gr.cached_build,
                                                  gr.repruned)
        assert abs(cr.recall - gr.recall) <= 0.05


# embedding_bag: D = 256 (the two-tower width, float4 rows), 8 (one
# lane-pass short of a warp), 18 (scalar rows, DIN's width), 600 (several
# lane groups); bags with pads and one all-pad bag
BAG_SHAPES = [(5000, 256, 300, 32), (100, 8, 64, 5), (700, 18, 33, 7),
              (2000, 600, 40, 3)]


def _bag_inputs(g, v, d, b, l, table_dtype, dev):
    table = torch.randn((v, d), generator=g).to(table_dtype).to(dev)
    ids = _ids(g, (b, l), v, dev)
    ids[0] = -1
    return table, ids


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weights", ["none", "int", "float"])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l", BAG_SHAPES)
def test_embedding_bag_kernel(dev, v, d, b, l, table_dtype, weights,
                              combiner):
    """Bit-equal to the plain version under unit, integer-valued and float
    weights: both round each fma of the chain once."""
    from repro_torch.kernels.embedding_bag import embedding_bag, \
        embedding_bag_cuda, embedding_bag_ref
    g = torch.Generator().manual_seed(v + d + l)
    table, ids = _bag_inputs(g, v, d, b, l, table_dtype, dev)
    w = {"none": None,
         "int": torch.randint(0, 4, (b, l), generator=g).float().to(dev),
         "float": torch.rand((b, l), generator=g).to(dev)}[weights]
    n0 = embedding_bag_cuda.launches
    got = embedding_bag(table, ids, w, combiner)
    assert embedding_bag_cuda.launches == n0 + 1     # no plain fallback
    want = embedding_bag_ref(table, ids, w, combiner)
    assert got.shape == (b, d) and got.dtype == torch.float32
    assert (got[0] == 0).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_embedding_bag_kernel_scalar_rows_on_a_misaligned_table(dev):
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_ref
    g = torch.Generator().manual_seed(11)
    base, ids = _bag_inputs(g, 301, 16, 50, 9, torch.float32, dev)
    table = base.view(-1)[1:1 + 300 * 16].view(300, 16)   # 4-byte aligned
    ids = ids.clamp_max(299)
    assert torch.equal(embedding_bag_cuda(table, ids, None, "mean"),
                       embedding_bag_ref(table, ids, None, "mean"))


@pytest.mark.cuda
def test_two_tower_bag_on_the_card_equals_the_cpu_bag(dev):
    """The model's history bag through the kernel equals the CPU's plain
    version bit for bit, and the score step returns finite scores."""
    from repro_torch.configs.two_tower_retrieval import SMOKE
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys
    from repro_torch.serve.serve_step import recsys_score_step
    model = recsys.two_tower_init(torch.Generator(device=dev).manual_seed(0),
                                  SMOKE)
    batch = recsys_batch(torch.Generator(device=dev).manual_seed(1), 64,
                         SMOKE)
    batch["sparse_ids"][1][3, 4:] = -1
    hist = torch.where(batch["sparse_ids"][1] >= 0,
                       batch["sparse_ids"][1]
                       + int(recsys._offsets(SMOKE)[1]), -1)
    with torch.inference_mode():
        bag = recsys._bag(None, model.table, hist)
        bag_cpu = recsys._bag(None, model.table.cpu(), hist.cpu())
    assert torch.equal(bag.cpu(), bag_cpu)
    scores = recsys_score_step(SMOKE)(model, batch)
    assert scores.shape == (64,) and bool(torch.isfinite(scores).all())


# embedding_bag at every launch-geometry edge: bags of one member, of a
# part of a 16-deep unrolled step, of one id load (32) and just over it,
# several id loads (100); rows of scalar lanes (18), of one float4 past a
# 128-column slice (132), of 2 and 3 slices; one bag, a part-filled block,
# and the serving batch
@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 512])
@pytest.mark.parametrize("d", [18, 132, 256, 384])
@pytest.mark.parametrize("l", [1, 4, 31, 32, 33, 100])
def test_embedding_bag_kernel_launch_geometry_edges(dev, l, d, b,
                                                    table_dtype):
    """Bit-equal to the plain version under unit and integer weights, both
    combiners, with pads (the first bag all pads when b > 1)."""
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_ref
    g = torch.Generator().manual_seed(l * 1000 + d + b)
    table = torch.randn((3000, d), generator=g).to(table_dtype).to(dev)
    ids = _ids(g, (b, l), 3000, dev)
    if b > 1:
        ids[0] = -1
    w = torch.randint(0, 4, (b, l), generator=g).float().to(dev)
    for weights in (None, w):
        for combiner in ("sum", "mean"):
            n0 = embedding_bag_cuda.launches
            got = embedding_bag_cuda(table, ids, weights, combiner)
            assert embedding_bag_cuda.launches == n0 + 1
            assert torch.equal(got, embedding_bag_ref(table, ids, weights,
                                                      combiner))


# embedding_bag's backward kernel against its plain version: D = 256
# (float4 lanes, two steps), 8 (two lanes), 18 and 600 (scalar and several
# lane steps); pads, an all-pad bag, ids repeated in and across bags and
# past the table, one id everywhere (a run of b * l members)
BAG_GRAD_SHAPES = [(5000, 256, 300, 32), (100, 8, 64, 5), (700, 18, 33, 7),
                   (2000, 600, 40, 3)]


def _bag_grad_inputs(g, v, d, b, l, dev):
    ids = _ids(g, (b, l), v, dev)
    ids[0] = -1
    ids[1, : min(l, 3)] = 2
    ids[-1, -1] = 2
    ids[2, 0] = v + 5                             # past the table: row v - 1
    grad = torch.randn((b, d), generator=g).to(dev)
    return ids, grad


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weights", ["none", "float"])
@pytest.mark.parametrize("v,d,b,l", BAG_GRAD_SHAPES)
def test_embedding_bag_backward_kernel(dev, v, d, b, l, weights, combiner):
    """Bit-equal to the plain version on the card: both add each row's
    terms in ascending (b, l) order, every rounding spelled out."""
    from repro_torch.kernels.embedding_bag import \
        embedding_bag_backward_cuda, embedding_bag_backward_ref
    g = torch.Generator().manual_seed(v + d + l + 1)
    ids, grad = _bag_grad_inputs(g, v, d, b, l, dev)
    w = None if weights == "none" else torch.rand((b, l), generator=g).to(
        dev)
    out = torch.zeros((v, d), device=dev)
    n0 = embedding_bag_backward_cuda.launches
    embedding_bag_backward_cuda(grad, ids, w, combiner, out)
    assert embedding_bag_backward_cuda.launches == n0 + 1
    want = embedding_bag_backward_ref(grad, ids, w, combiner, v)
    assert torch.equal(out, want)
    assert torch.equal(out.cpu(), embedding_bag_backward_ref(
        grad.cpu(), ids.cpu(), None if w is None else w.cpu(), combiner, v))


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_backward_kernel_edges(dev, combiner):
    """One id in every slot (one run of b * l members), an all-pad batch,
    and the kernel adding into a gradient that is not zero."""
    from repro_torch.kernels.embedding_bag import \
        embedding_bag_backward_cuda, embedding_bag_backward_ref
    g = torch.Generator().manual_seed(4)
    grad = torch.randn((70, 256), generator=g).to(dev)
    same = torch.full((70, 40), 9, dtype=torch.int32, device=dev)
    out = torch.zeros((20, 256), device=dev)
    embedding_bag_backward_cuda(grad, same, None, combiner, out)
    assert torch.equal(out, embedding_bag_backward_ref(grad, same, None,
                                                       combiner, 20))
    pads = torch.full((70, 40), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((20, 256), device=dev)
    embedding_bag_backward_cuda(grad, pads, None, combiner, zero)
    assert not zero.any()
    base = torch.randn((20, 256), generator=g).to(dev)
    added = embedding_bag_backward_cuda(grad, same, None, combiner,
                                        base.clone())
    assert torch.equal(added, base + out)


@pytest.mark.cuda
def test_embedding_bag_backward_kernel_at_the_two_tower_path_shape(dev):
    """B = 65,536 bags of 32 over the 2M-row history table at D = 256, the
    full two-tower training step's operands (mean, no pads), bit-equal."""
    from repro_torch.kernels.embedding_bag import \
        embedding_bag_backward_cuda, embedding_bag_backward_ref
    g = torch.Generator(device=dev).manual_seed(6)
    ids = torch.randint(0, 2_000_000, (65_536, 32), generator=g, device=dev,
                        dtype=torch.int32)
    grad = torch.randn((65_536, 256), generator=g, device=dev)
    out = torch.zeros((2_000_000, 256), device=dev)
    embedding_bag_backward_cuda(grad, ids, None, "mean", out)
    want = embedding_bag_backward_ref(grad, ids, None, "mean", 2_000_000)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_embedding_bag_is_differentiable_on_the_card(dev):
    """The card's bag output carries the same autograd function as the
    CPU's, and its table gradient equals the CPU's bit for bit."""
    from repro_torch.kernels.embedding_bag import embedding_bag, \
        embedding_bag_backward_cuda
    g = torch.Generator().manual_seed(8)
    table = torch.randn((300, 32), generator=g)
    ids = _ids(g, (40, 6), 300, torch.device("cpu"))
    cot = torch.randn((40, 32), generator=g)
    grads = []
    for device in (dev, torch.device("cpu")):
        t = table.to(device).requires_grad_()
        out = embedding_bag(t, ids.to(device), None, "mean")
        assert type(out.grad_fn).__name__ == "EmbeddingBagFunctionBackward"
        n0 = embedding_bag_backward_cuda.launches
        (gt,) = torch.autograd.grad(out, t, cot.to(device))
        assert embedding_bag_backward_cuda.launches == \
            n0 + (device.type == "cuda")
        grads.append(gt.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_two_tower_train_step_on_the_card_equals_the_cpu(dev):
    """One step of the two-tower smoke model (mixed optimizer) on the card
    and on the CPU from the same weights and batch: parameters to rtol
    1e-5 (the towers' products and the lookups' index backward sum in
    other orders on the card)."""
    from repro_torch.configs.two_tower_retrieval import SMOKE
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda
    from repro_torch.models import recsys
    from repro_torch.optim import mixed_optimizer
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    cpu = torch.device("cpu")
    batch = recsys_batch(torch.Generator().manual_seed(1), 64, SMOKE)
    batch["sparse_ids"][1][3, 4:] = -1
    out = []
    for device in (dev, cpu):
        model = recsys.two_tower_init(torch.Generator().manual_seed(0),
                                      SMOKE).to(device)
        opt = mixed_optimizer(1e-3)
        step = make_train_step(loss_fn_for("recsys", SMOKE), opt)
        n0 = embedding_bag_backward_cuda.launches
        model, _, m = step(model, opt.init(model),
                           {k: [x.to(device) for x in v]
                            if isinstance(v, list) else v.to(device)
                            for k, v in batch.items()})
        assert embedding_bag_backward_cuda.launches == \
            n0 + (device.type == "cuda")
        out.append((float(m["loss"]), {n: p.detach().cpu() for n, p in
                                       model.named_parameters()}))
    (lc, pc), (lg, pg) = out[1], out[0]
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    for n, p in pc.items():
        torch.testing.assert_close(pg[n], p, rtol=1e-5, atol=1e-6)


# -- the hop loop kernel (beam_hops) against the host loop over the one-hop
# kernel: the same states, every field and counter, bit for bit

def _loop_inputs(dev, dist_backend, n=2000, d=40, nq=96, ef=16, r=12):
    """Integer data with many tied distances, a kNN graph with -1 pads and
    the entry-seeded loop state; pq: integer LUT entries over random codes."""
    from repro_torch.core.beam_search import _seed_batched
    from repro_torch.kernels.gather_dist import gather_dist
    from repro_torch.kernels.lut_dist import lut_dist
    g = torch.Generator().manual_seed(31)
    data = torch.randint(-3, 4, (n, d), generator=g).float().to(dev)
    q = torch.randint(-3, 4, (nq, d), generator=g).float().to(dev)
    _, nbrs = knn_graph(data, r)
    nbrs[::7, r - 3:] = -1
    entry = torch.randint(0, n, (nq,), generator=g,
                          dtype=torch.int32).to(dev)
    if dist_backend == "f32":
        q_or_lut, table, gd = q, data, gather_dist
    else:
        table = torch.randint(0, 16, (n, 8), generator=g,
                              dtype=torch.uint8).to(dev)
        q_or_lut = torch.randint(0, 6, (nq, 8, 16), generator=g).float().to(
            dev)
        gd = lambda q_, db_, ids: lut_dist(q_or_lut, table, ids)
    state = _seed_batched(q, data, nbrs, entry, ef, gd)
    return state, q_or_lut, table, nbrs


def _host_loop(state, q_or_lut, table, nbrs, dist_backend, **kw):
    from repro_torch.core.beam_search import _expand_fused, _run_hops
    body = lambda s: _expand_fused(s, q_or_lut, table, nbrs, dist_backend)
    return _run_hops(state, body, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [1, 7, 40])
@pytest.mark.parametrize("patience", [None, 2])
@pytest.mark.parametrize("mode", ["while", "fori"])
@pytest.mark.parametrize("dist_backend", ["f32", "pq"])
def test_hop_loop_kernel_equals_the_host_loop(dev, dist_backend, mode,
                                              patience, max_steps):
    from repro_torch.core.beam_search import _run_hop_slices
    from repro_torch.kernels.beam_hop import beam_hops_cuda, \
        beam_hops_lut_cuda
    state, q_or_lut, table, nbrs = _loop_inputs(dev, dist_backend)
    kw = dict(k=10, max_iters=40, mode=mode, patience=patience, eps=0.0)
    want = _host_loop(state, q_or_lut, table, nbrs, dist_backend, **kw)
    wrapper = beam_hops_cuda if dist_backend == "f32" else beam_hops_lut_cuda
    n0 = wrapper.launches
    got = _run_hop_slices(state, q_or_lut, table, nbrs, dist_backend,
                          max_steps=max_steps, **kw)
    assert wrapper.launches > n0
    if mode == "fori":
        assert wrapper.launches - n0 == -(-40 // max_steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dist_backend", ["f32", "pq"])
def test_hop_loop_kernel_equals_its_plain_version(dev, dist_backend):
    """One slice, every output: the kernel against beam_hops_ref on the
    card, iterations and the exit live test included, with a lane whose
    unvisited entries all sit at +inf."""
    from repro_torch.kernels.beam_hop import beam_hops, beam_hops_ref
    state, q_or_lut, table, nbrs = _loop_inputs(dev, dist_backend)
    pool_i, pool_d, pool_v = (t.clone() for t in state[:3])
    pool_i[0, :3] = torch.tensor([5, 7, -1])
    pool_d[0, :3] = torch.tensor([3.0, float("inf"), float("inf")])
    pool_v[0, :3] = torch.tensor([True, False, False])
    args = (nbrs, pool_i, pool_d, pool_v, state[3], state[4], state[5],
            state[7], q_or_lut, table)
    for patience in (None, 3):
        kw = dict(k=10, max_iters=40, max_steps=9, patience=patience,
                  eps=0.0)
        got = beam_hops(*args, dist_backend, backend="cuda", **kw)
        want = beam_hops_ref(*args, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[7][0]) == (9 if patience is None else 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_fused_search_takes_one_loop_launch(dev, mode):
    """A fused search on the card runs its whole loop in one beam_hops
    launch, and the while mode syncs the host once for it."""
    from repro_torch.kernels.beam_hop import beam_hop_cuda, beam_hops_cuda
    state, q, data, nbrs = _loop_inputs(dev, "f32")
    entry = state[0][:, 0]
    h0, l0 = beam_hop_cuda.launches, beam_hops_cuda.launches
    s0 = beam_search.host_syncs
    beam_search(q, data, nbrs, entry, ef=16, k=10, mode=mode,
                hop_backend="fused")
    assert beam_hops_cuda.launches - l0 == 1
    assert beam_hop_cuda.launches == h0
    assert beam_search.host_syncs - s0 == (1 if mode == "while" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [600, 37, 1100, 8])
def test_gather_dist_kernel_on_pad_heavy_ids(dev, d):
    """Mostly -1 ids (the alpha-scan's keep table), ids >= N (clamped to the
    last row), misaligned rows (the scalar path), D % 4 != 0 and D past the
    grouped path's 1024: the plain version's bits on integer data."""
    g = torch.Generator().manual_seed(d + 5)
    n = 3000
    q = _vectors(g, (300, d), "int", dev)
    db = _vectors(g, (n + 1, d), "int", dev)
    ids = torch.randint(0, n + 40, (300, 32), generator=g,
                        dtype=torch.int32).to(dev)
    ids[torch.rand((300, 32), generator=g).to(dev) < 0.7] = -1
    ids[5] = -1
    for rows in (db[:n], db.view(-1)[1:1 + n * d].view(n, d)):
        got = gather_dist_cuda(q, rows, ids)
        assert torch.equal(got, gather_dist_ref(q, rows, ids.clamp_max(
            n - 1)))
        assert bool(torch.isinf(got[ids < 0]).all())


@pytest.mark.cuda
def test_embedding_bag_kernel_rounds_the_weighted_sum_once(dev):
    """A weighted sum whose float64 sum is a float32 midpoint short of the
    exact sum: the kernel's fma and the plain version give the same bits."""
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_ref
    table = torch.tensor([[1.0], [16773185 * 2.0 ** -48]], device=dev)
    ids = torch.tensor([[0, 1], [0, 1]], dtype=torch.int32, device=dev)
    w = torch.tensor([[1.0, 8390624 * 2.0 ** -23],
                      [-1.0, -8390624 * 2.0 ** -23]], device=dev)
    got = embedding_bag_cuda(table, ids, w, "sum")
    want = embedding_bag_ref(table, ids, w, "sum")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.view(torch.int32)[0, 0].item() == 0x3F800001


# -- the LUT hop loop's persistent variant (beam_hop.route): against the
# host loop over the one-hop kernel (which keeps lut_row_sum) and against
# beam_hops_ref, every output, bit for bit

def _lut_loop_inputs(dev, m, c, kind, aligned=True, nq=96, n=2000, r=12,
                     ef=16):
    """A kNN graph with -1 pads over random integer rows, codes over all of
    0..255 (so codes above C - 1 take the clamp), the LUT and the
    entry-seeded loop state; unaligned: the codes start one byte into
    their buffer (code rows read byte by byte)."""
    from repro_torch.core.beam_search import _seed_batched
    from repro_torch.kernels.lut_dist import lut_dist
    g = torch.Generator().manual_seed(m * 1000 + c)
    data = torch.randint(-3, 4, (n, 16), generator=g).float().to(dev)
    _, nbrs = knn_graph(data, r)
    nbrs[::7, r - 3:] = -1
    raw = torch.randint(0, 256, (n * m + 1,), generator=g,
                        dtype=torch.uint8).to(dev)
    codes = (raw[:n * m] if aligned else raw[1:]).view(n, m)
    lut = _lut(g, (nq, m, c), kind, dev)
    entry = torch.randint(0, n, (nq,), generator=g,
                          dtype=torch.int32).to(dev)
    state = _seed_batched(lut, codes, nbrs, entry, ef,
                          lambda q_, db_, ids: lut_dist(lut, codes, ids))
    return state, lut, codes, nbrs


def _lut_loop_args(state, lut, codes, nbrs):
    return (nbrs, *state[:6], state[7], lut, codes)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("c", [1, 16, 256])
@pytest.mark.parametrize("m", [1, 3, 7, 300, 600])
def test_lut_loop_persistent_equals_host_loop_and_plain(dev, m, c, kind,
                                                        aligned):
    from repro_torch.core.beam_search import _run_hop_slices
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda, \
        beam_hops_ref
    from repro_torch.kernels.beam_hop.beam_hop import _card, route
    state, lut, codes, nbrs = _lut_loop_inputs(dev, m, c, kind, aligned)
    assert route(m, c, 12, 16, *_card(codes.device)).variant == "persistent"
    kw = dict(k=10, max_iters=40, mode="while", patience=None, eps=0.0)
    want = _host_loop(state, lut, codes, nbrs, "pq", **kw)
    n0 = dict(beam_hops_lut_cuda.by_variant)
    got = _run_hop_slices(state, lut, codes, nbrs, "pq", max_steps=40, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].sum()) > 0
    del kw["mode"]
    args = _lut_loop_args(state, lut, codes, nbrs)
    got9 = beam_hops_lut_cuda(*args, max_steps=40, **kw)
    for a, b in zip(got9, beam_hops_ref(*args, max_steps=40, **kw)):
        assert torch.equal(a, b)
    assert beam_hops_lut_cuda.by_variant["persistent"] == n0["persistent"] + 2
    assert beam_hops_lut_cuda.by_variant["per_query"] == n0["per_query"]


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [1, 7, 40])
@pytest.mark.parametrize("patience", [None, 2])
@pytest.mark.parametrize("mode", ["while", "fori"])
def test_lut_loop_persistent_in_slices(dev, mode, patience, max_steps):
    """The loop at M = 300, C = 256 on float LUTs, run in slices of
    max_steps hops, equals the host loop in every field."""
    from repro_torch.core.beam_search import _run_hop_slices
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda
    state, lut, codes, nbrs = _lut_loop_inputs(dev, 300, 256, "float")
    kw = dict(k=10, max_iters=40, mode=mode, patience=patience, eps=0.0)
    want = _host_loop(state, lut, codes, nbrs, "pq", **kw)
    n0 = beam_hops_lut_cuda.by_variant["persistent"]
    got = _run_hop_slices(state, lut, codes, nbrs, "pq",
                          max_steps=max_steps, **kw)
    if mode == "fori":
        assert beam_hops_lut_cuda.by_variant["persistent"] - n0 == \
            -(-40 // max_steps)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", ["route", 0])
@pytest.mark.parametrize("grid", [1, 7, "route"])
@pytest.mark.parametrize("m", [300, 600])
def test_lut_loop_grid_and_residency_do_not_change_the_result(dev, m, grid,
                                                              resident):
    """Q = 96 lanes (not a multiple of 7), lane 0 stuck with its unvisited
    entries at +inf: every grid and residency, and the per_query variant,
    give beam_hops_ref's 9 outputs."""
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda, \
        beam_hops_ref
    from repro_torch.kernels.beam_hop.beam_hop import LutPlan, _card, route
    state, lut, codes, nbrs = _lut_loop_inputs(dev, m, 256, "float")
    pool_i, pool_d, pool_v = (t.clone() for t in state[:3])
    pool_i[0, :3] = torch.tensor([5, 7, -1])
    pool_d[0, :3] = torch.tensor([3.0, float("inf"), float("inf")])
    pool_v[0, :3] = torch.tensor([True, False, False])
    state = (pool_i, pool_d, pool_v) + tuple(state[3:])
    plan = route(m, 256, 12, 16, *_card(codes.device))
    plan = plan._replace(
        grid=plan.grid if grid == "route" else grid,
        resident=plan.resident if resident == "route" else resident)
    args = _lut_loop_args(state, lut, codes, nbrs)
    kw = dict(k=10, max_iters=40, max_steps=9, patience=3, eps=0.0)
    want = beam_hops_ref(*args, **kw)
    for p in (plan, LutPlan("per_query", 0, 0)):
        for a, b in zip(beam_hops_lut_cuda(*args, plan=p, **kw), want):
            assert torch.equal(a, b)
    assert int(want[7][0]) == 3


@pytest.mark.cuda
def test_lut_loop_empty_batch(dev):
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda
    state, lut, codes, nbrs = _lut_loop_inputs(dev, 300, 256, "int")
    empty = tuple(t[:0] for t in state)
    out = beam_hops_lut_cuda(nbrs, *empty[:6], empty[7], lut[:0], codes,
                             k=10, max_iters=40, max_steps=40)
    assert [t.shape[0] for t in out] == [0] * 9


@pytest.mark.cuda
@pytest.mark.parametrize("m,variant", [(300, "persistent"),
                                       (2048, "per_query")])
def test_lut_loop_route_picks_the_counted_variant(dev, m, variant):
    """route decides from the shape; the wrapper launches and counts that
    variant, and both equal beam_hops_ref."""
    from repro_torch.kernels.beam_hop import beam_hops_lut_cuda, \
        beam_hops_ref
    from repro_torch.kernels.beam_hop.beam_hop import _card, route
    state, lut, codes, nbrs = _lut_loop_inputs(dev, m, 256, "float", nq=24,
                                               r=32)
    assert route(m, 256, 32, 16, *_card(codes.device)).variant == variant
    n0 = dict(beam_hops_lut_cuda.by_variant)
    args = _lut_loop_args(state, lut, codes, nbrs)
    kw = dict(k=10, max_iters=40, max_steps=40)
    for a, b in zip(beam_hops_lut_cuda(*args, **kw),
                    beam_hops_ref(*args, **kw)):
        assert torch.equal(a, b)
    assert {v: beam_hops_lut_cuda.by_variant[v] - n0[v] for v in n0} == \
        {v: int(v == variant) for v in n0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,r,ef,resident", [
    (300, 256, 32, 64, 200), (600, 256, 32, 64, 148), (7, 1, 12, 16, 7),
    (3, 16, 32, 64, 0), (1, 256, 128, 8, 1), (600, 256, 32, 64, 0)])
def test_lut_loop_smem_layout_matches_the_kernel(dev, m, c, r, ef, resident):
    """The route's shared-memory formula is the kernel's own."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.beam_hop.beam_hop import persistent_smem_bytes
    lib = cuda_lib.library()
    assert lib.beam_hops_lut_smem_bytes(ef, r, m, c, resident) == \
        persistent_smem_bytes(ef, r, m, c, resident)


# -- NN-Descent, the table pools and the device finish on the card: the
# same draws (made on the CPU) and integer data give the CPU's results bit
# for bit, so every duplicate-index scatter resolves the same on CUDA

class _CpuDraws:
    """NN-Descent draws from a CPU generator, the projection taken on the
    CPU, so the card and the CPU get the same numbers."""

    def __init__(self, seed):
        from repro_torch.core.build.nn_descent import NNDDraws
        self.draws = NNDDraws(torch.Generator().manual_seed(seed))

    def rp_order(self, data):
        return self.draws.rp_order(data.cpu()).to(data.device)

    def round(self, n, k, s_rev, device):
        return self.draws.round(n, k, s_rev, device)


def _int_table(n, d, k, seed):
    """Symmetric integer data (x and -x: the mean, and so the medoid, is
    exact on both devices), its exact kNN table with holes, fresh flags."""
    g = torch.Generator().manual_seed(seed)
    half = torch.randint(-7, 8, (n // 2, d), generator=g).float()
    data = torch.cat([half, -half])
    dists, ids = knn_graph(data, k)
    holes = torch.rand(ids.shape, generator=g) < 0.2
    ids = torch.where(holes, -1, ids)
    dists = torch.where(holes, float("inf"), dists)
    order = torch.sort(dists, dim=1, stable=True).indices
    fresh = (torch.rand(ids.shape, generator=g) < 0.5) & (ids >= 0)
    return data, ids.gather(1, order), dists.gather(1, order), fresh


@pytest.mark.cuda
@pytest.mark.parametrize("s_rev,u_slots", [(5, 40), (1, 4)])
def test_nn_descent_round_on_the_card_equals_the_cpu(dev, s_rev, u_slots):
    from repro_torch.core.build.nn_descent import NNDDraws, _round
    n, k = 3000, 20
    data, ids, dists, fresh = _int_table(n, 16, k, 0)
    norms = (data * data).sum(-1)
    draws = NNDDraws(torch.Generator().manual_seed(1)).round(n, k, s_rev,
                                                             "cpu")
    cpu = _round(draws, data, norms, ids, dists, fresh, 5, s_rev, u_slots,
                 512)
    card_draws = type(draws)(*(x.to(dev) if torch.is_tensor(x) else x
                               for x in draws))
    topk_merge_cuda.launches = 0
    card = _round(card_draws, data.to(dev), norms.to(dev), ids.to(dev),
                  dists.to(dev), fresh.to(dev), 5, s_rev, u_slots, 512)
    assert topk_merge_cuda.launches == -(-n // 512)
    for c, g in zip(cpu, card):
        assert torch.equal(c, g.cpu())


@pytest.mark.cuda
def test_nn_descent_on_the_card_equals_the_cpu(dev):
    from repro_torch.core.build.nn_descent import nn_descent
    g = torch.Generator().manual_seed(2)
    data = torch.randint(0, 16, (5000, 12), generator=g).float()
    init = torch.randint(-1, 5000, (5000, 10), generator=g)
    for kw in (dict(), dict(init_ids=init, init_passes=1, rounds=3)):
        cpu = nn_descent(data, 16, draws=_CpuDraws(3), with_stats=True, **kw)
        card = nn_descent(data.to(dev), 16, draws=_CpuDraws(3),
                          with_stats=True, **kw)
        assert torch.equal(cpu[0], card[0].cpu())
        assert torch.equal(cpu[1], card[1].cpu())
        assert cpu[2] == card[2]


@pytest.mark.cuda
def test_table_pools_and_device_finish_on_the_card_equal_the_cpu(dev):
    from repro_torch.core.build.finish import (
        finish_nsg, propagate_reach, reachable_from,
        repair_connectivity_device,
    )
    from repro_torch.core.build.pools import nnd_candidate_pools
    from repro_torch.core.nsg import build_nsg
    n = 4000
    data, ids, dists, _ = _int_table(n, 16, 16, 4)
    cpu = nnd_candidate_pools(data, ids, dists, 32, chunk=1024)
    card = nnd_candidate_pools(data.to(dev), ids.to(dev), dists.to(dev), 32,
                               chunk=1024)
    assert torch.equal(cpu[0], card[0].cpu())
    assert torch.equal(cpu[1], card[1].cpu())
    assert cpu[2] == card[2]
    # a whole build through them, then repair of a graph with islands
    g_cpu, s_cpu = build_nsg(data, ids, degree=12, n_candidates=32,
                             chunk=1024, knn_dists=dists, with_stats=True)
    g_card, s_card = build_nsg(data.to(dev), ids.to(dev), degree=12,
                               n_candidates=32, chunk=1024,
                               knn_dists=dists.to(dev), with_stats=True)
    assert torch.equal(g_cpu.neighbors, g_card.neighbors.cpu())
    assert s_cpu[:5] == s_card[:5]
    assert s_card.finish_backend == "device"
    nbrs = g_cpu.neighbors.clone()
    cut = torch.randperm(n, generator=torch.Generator().manual_seed(5))[:300]
    nbrs[torch.isin(nbrs, cut)] = -1
    medoid = int(g_cpu.medoid)
    out = [repair_connectivity_device(data.to(d_), nbrs.to(d_), medoid,
                                      ids.to(d_), return_protected=True)
           for d_ in ("cpu", dev)]
    assert out[0][2] == out[1][2] >= 1
    assert torch.equal(out[0][0], out[1][0].cpu())
    assert torch.equal(out[0][1], out[1][1].cpu())
    assert reachable_from(out[1][0].cpu().numpy(), medoid).all()
    f_cpu, fs_cpu = finish_nsg(data, nbrs, medoid, ids, degree=12)
    f_card, fs_card = finish_nsg(data.to(dev), nbrs.to(dev), medoid,
                                 ids.to(dev), degree=12)
    assert torch.equal(f_cpu, f_card.cpu())
    assert fs_cpu.repair_rounds == fs_card.repair_rounds
    steps = propagate_reach.steps
    seed = torch.zeros(n, dtype=torch.bool, device=dev)
    seed[medoid] = True
    assert propagate_reach(f_card, seed).all()
    assert propagate_reach.steps > steps


# -- the α-scan kernel (csrc/alpha_scan.cu) against its plain version. The
# plain version scores the kept rows through gather_dist's kernel, and the
# kernel through the same reduction, so they agree bit for bit on float
# data too.

def _scan_inputs(b, l, n, d, kind, dev, seed=0):
    """Distance-ascending candidate pools of b nodes over n rows: each
    node's l nearest rows (so occlusion bites), with its own id, a
    duplicate and -1 pads mixed in, re-sorted by the plain gather."""
    g = torch.Generator().manual_seed(seed)
    data = _vectors(g, (n, d), kind, dev)
    _, ids = knn_graph(data, l)
    nodes = torch.randint(0, n, (b,), generator=g, dtype=torch.int32).to(dev)
    ids = ids[nodes.long()].clone()
    ids[:, 5] = nodes                                     # self
    ids[:, 7] = ids[:, 2]                                 # a duplicate
    ids[(torch.rand((b, l), generator=g) < 0.1).to(dev)] = -1
    dists = gather_dist_ref(data[nodes.long()], data, ids)
    order = torch.sort(dists, dim=1, stable=True).indices
    return data, nodes, ids.gather(1, order), dists.gather(1, order)


# (B, L, degree, D, per-row alpha): the prune stage, the interconnect's
# re-prune, a reprune_family pass (9 alphas x 2048 rows), scalar rows
SCAN_SHAPES = [(2048, 64, 32, 600, False), (2048, 96, 32, 600, False),
               (9 * 2048, 32, 32, 600, True), (256, 40, 16, 37, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("b,l,degree,d,per_row", SCAN_SHAPES)
def test_alpha_scan_kernel_equals_the_plain_version(dev, b, l, degree, d,
                                                    per_row, kind):
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda, \
        alpha_scan_ref
    data, nodes, ids, dists = _scan_inputs(b // 9 if per_row else b, l,
                                           6000, d, kind, dev)
    if per_row:
        nodes, ids, dists = nodes.repeat(9), ids.repeat(9, 1), \
            dists.repeat(9, 1)
        alphas = torch.linspace(1.0, 1.4, 9, device=dev)
        alpha_list = [alphas.repeat_interleave(b // 9)]
    else:
        alpha_list = [1.0, 1.2]
    for alpha in alpha_list:
        n0 = alpha_scan_cuda.launches
        keep, mask = alpha_scan_cuda(data, nodes, ids, dists, degree, alpha)
        assert alpha_scan_cuda.launches == n0 + 1
        want_keep, want_mask = alpha_scan_ref(data, nodes, ids, dists,
                                              degree, alpha)
        assert torch.equal(keep, want_keep) and torch.equal(mask, want_mask)
        assert 0 < int(mask.sum()) < int((ids >= 0).sum())


@pytest.mark.cuda
def test_alpha_scan_kernel_operand_checks_and_counts(dev):
    from repro_torch.core.build.prune import prune_in_chunks
    from repro_torch.kernels.alpha_scan import alpha_scan, alpha_scan_cuda, \
        alpha_scan_ref
    data, nodes, ids, dists = _scan_inputs(300, 24, 2000, 40, "int", dev)
    n0 = alpha_scan_cuda.launches
    bad = [
        (data.double(), nodes, ids, dists, 8, 1.0),
        (data, nodes.long(), ids, dists, 8, 1.0),
        (data, nodes, ids.long(), dists, 8, 1.0),
        (data, nodes, ids, dists[:, :-1], 8, 1.0),
        (data, nodes[:-1], ids, dists, 8, 1.0),
        (data, nodes, ids, dists, 25, 1.0),                  # degree > L
        (data, nodes, ids, dists, 0, 1.0),
        (data, nodes, ids.t().contiguous().t(), dists, 8, 1.0),
        (data.cpu(), nodes, ids, dists, 8, 1.0),
        (data, nodes, ids, dists, 8, torch.ones(299, device=dev)),
        (data, nodes, ids, dists, 8, torch.ones(300, device=dev).double()),
    ]
    for args in bad:
        with pytest.raises((ValueError, TypeError)):
            alpha_scan_cuda(*args)
    assert alpha_scan_cuda.launches == n0
    keep, mask = alpha_scan_cuda(data, nodes[:0], ids[:0], dists[:0], 8, 1.0)
    assert keep.shape == (0, 8) and mask.shape == (0, 24)
    assert alpha_scan_cuda.launches == n0                    # B = 0
    # the dispatch: a degree past L scans at L and pads with -1
    keep, mask = alpha_scan(data, nodes, ids, dists, 30, 1.1)
    want = alpha_scan_ref(data, nodes, ids, dists, 30, 1.1)
    assert torch.equal(keep, want[0]) and torch.equal(mask, want[1])
    assert alpha_scan_cuda.launches == n0 + 1
    # one launch per chunk through prune_in_chunks
    prune_in_chunks(data, nodes, ids, dists, 8, 128, 1.0)
    assert alpha_scan_cuda.launches == n0 + 1 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("b,l,degree,d,per_row", SCAN_SHAPES[:3],
                         ids=["prune", "interconnect", "family"])
@pytest.mark.parametrize("variant", ["warp", "staged"])
def test_alpha_scan_variants_equal_the_plain_version(dev, variant, b, l,
                                                     degree, d, per_row,
                                                     kind):
    """Each variant, forced, at the three path shapes: keep and mask equal
    to the plain version's (torch.equal), one launch per call counted under
    that variant alone; the route gives staged at these shapes."""
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda, \
        alpha_scan_ref
    from repro_torch.kernels.alpha_scan.alpha_scan import route
    assert route(degree, l, d) == "staged"
    data, nodes, ids, dists = _scan_inputs(b // 9 if per_row else b, l,
                                           6000, d, kind, dev, seed=3)
    if per_row:
        nodes, ids, dists = nodes.repeat(9), ids.repeat(9, 1), \
            dists.repeat(9, 1)
        alpha = torch.linspace(1.0, 1.4, 9, device=dev).repeat_interleave(
            b // 9)
    else:
        alpha = 1.2
    before = dict(alpha_scan_cuda.by_variant)
    keep, mask = alpha_scan_cuda(data, nodes, ids, dists, degree, alpha,
                                 variant=variant)
    assert {v: c - before[v] for v, c in alpha_scan_cuda.by_variant.items()} \
        == {v: int(v == variant) for v in before}
    want_keep, want_mask = alpha_scan_ref(data, nodes, ids, dists, degree,
                                          alpha)
    assert torch.equal(keep, want_keep) and torch.equal(mask, want_mask)
    assert 0 < int(mask.sum()) < int((ids >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("degree,l,d", [(1, 8, 4), (3, 40, 8), (63, 200, 300),
                                        (32, 600, 600), (7, 9, 1024)])
def test_alpha_scan_staged_variant_at_its_edges(dev, degree, l, d):
    """The staged kernel on shapes the path does not give it: degree 1,
    degrees past its kept-row slots (63 over 13 slots at D = 300, 32 over 4
    with pools of 600), the widest rows it takes."""
    from repro_torch.kernels.alpha_scan import alpha_scan_cuda, \
        alpha_scan_ref
    data, nodes, ids, dists = _scan_inputs(97, l, 3000, d, "float", dev,
                                           seed=l + d)
    for alpha in (1.0, 1.3):
        got = alpha_scan_cuda(data, nodes, ids, dists, degree, alpha,
                              variant="staged")
        want = alpha_scan_ref(data, nodes, ids, dists, degree, alpha)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_alpha_scan_route_and_forced_variants_on_the_card(dev):
    from repro_torch.kernels.alpha_scan import alpha_scan, alpha_scan_cuda, \
        alpha_scan_ref
    data, nodes, ids, dists = _scan_inputs(64, 40, 2000, 37, "int", dev)
    with pytest.raises(ValueError, match="staged variant"):
        alpha_scan_cuda(data, nodes, ids, dists, 16, 1.0, variant="staged")
    with pytest.raises(ValueError, match="unknown variant"):
        alpha_scan_cuda(data, nodes, ids, dists, 16, 1.0, variant="block")
    before = dict(alpha_scan_cuda.by_variant)
    keep, mask = alpha_scan(data, nodes, ids, dists, 16, 1.0)   # D = 37
    assert alpha_scan_cuda.by_variant["warp"] == before["warp"] + 1
    want = alpha_scan_ref(data, nodes, ids, dists, 16, 1.0)
    assert torch.equal(keep, want[0]) and torch.equal(mask, want[1])
    # the dispatch passes a forced variant through
    data4 = data[:, :36].contiguous()
    keep, mask = alpha_scan(data4, nodes, ids, dists, 16, 1.0,
                            variant="warp")
    assert alpha_scan_cuda.by_variant["warp"] == before["warp"] + 2
    assert alpha_scan_cuda.by_variant["staged"] == before["staged"]
    want = alpha_scan_ref(data4, nodes, ids, dists, 16, 1.0)
    assert torch.equal(keep, want[0]) and torch.equal(mask, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["f32", "pq"])
def test_compacted_search_equals_the_uncompacted_one_on_the_card(dev,
                                                                 backend):
    from repro_torch.core.beam_search import beam_search_compacted
    from repro_torch.core.quant import make_codec
    g = torch.Generator().manual_seed(11)
    data = torch.randn((4000, 64), generator=g).to(dev)
    _, nbrs = knn_graph(data, 16)
    q = data[:300] + 0.05 * torch.randn((300, 64), generator=g).to(dev)
    entry = torch.zeros(300, dtype=torch.int32, device=dev)
    kw = dict(ef=32, k=10, with_stats=True)
    if backend == "pq":
        codec = make_codec("pq", 64, 16)
        codec.fit(data, generator=torch.Generator().manual_seed(0))
        kw.update(dist_backend="pq", codes=codec.encode(data).contiguous(),
                  lut=codec.lut(q))
    for patience in (None, 4):
        plain = beam_search(q, data, nbrs, entry, hop_backend="fused",
                            patience=patience, **kw)
        log = []
        got = beam_search_compacted(q, data, nbrs, entry, compact_every=8,
                                    patience=patience, shape_log=log, **kw)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1],
                                                             plain[1])
        for a, b in zip(got[2][:3], plain[2][:3]):
            assert torch.equal(a, b)
        assert (got[2].wasted_hops <= plain[2].wasted_hops).all()
        assert log[0] == 512 and all(a >= b for a, b in zip(log, log[1:]))


# ------------------------------------------- the index families on the card
def _family_data(seed=0, n=1500, d=32, m=8, c=16):
    """Integer rows: 4 coarse centers (multiples of 128, far beyond the
    rows' spread) plus, per sub-space, one of c prototypes (in [0, 64)),
    each row beside its negation in its group. A 4-list or 4-cluster
    k-means finds the groups, whose means are their centers, so every
    centroid, residual, codeword and LUT entry is an integer; every |x|^2
    stays below 2^24, so every distance is exact in either arithmetic
    (diff-square or norm expansion) on either device."""
    g = torch.Generator().manual_seed(seed)
    dsub = d // m
    protos = torch.stack([torch.randperm(64, generator=g)[:c * dsub]
                          .reshape(c, dsub) for _ in range(m)])
    pick = torch.randint(0, c, (n // 2, m), generator=g)
    half = protos[torch.arange(m)[None, :], pick].reshape(n // 2, d)
    centers = torch.randint(-4, 5, (4, d), generator=g) * 128
    group = torch.arange(n // 2).repeat(2) % 4
    x = torch.cat([half, -half]) + centers[group]
    q = x[torch.randint(0, n, (64,), generator=g)] + torch.randint(
        -2, 3, (64, d), generator=g)
    return x.float(), q.float()


FAMILY_SPECS = ["Flat", "IVF4", "IVF4,PQ8", "IVFPQ4x8", "PQ8", "HNSW8",
                "HNSW8,EP4", "NSG12,EP4", "PCA16,IVF4"]


@pytest.mark.cuda
@pytest.mark.parametrize("spec", FAMILY_SPECS)
def test_family_search_on_the_card_equals_the_cpu(dev, spec):
    """The same index (built on the CPU, carried by its state) searched on
    the card through the kernels and on the CPU through their plain
    versions: ids equal exactly on integer data, dists too (PCA: floats,
    to rtol 1e-5)."""
    from repro_torch.core.index_api import SearchParams, build_index
    from repro_torch.core.persist import index_from_state, index_state
    x, q = _family_data()
    cpu = build_index(spec, x, device="cpu")
    card = index_from_state(index_state(cpu), device=dev)
    for p in (None, SearchParams(ef_search=32, nprobe=2)):
        dc, ic = cpu.search(q, 10, p)
        dg, ig = card.search(q.to(dev), 10, p)
        if spec.startswith("PCA"):
            assert (ig.cpu() == ic).all(1).float().mean() >= 0.99
            torch.testing.assert_close(dg.cpu(), dc, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(ig.cpu(), ic), spec
            assert torch.equal(dg.cpu(), dc), spec


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["IVF4", "PQ8", "IVFPQ4x8", "HNSW8"])
def test_family_fit_on_the_card_equals_the_cpu(dev, spec):
    """A fit on the card (k-means through l2topk) equals the CPU fit from
    the same generator seed on integer data, array for array."""
    from repro_torch.core.index_api import build_index
    from repro_torch.core.persist import index_state
    x, _ = _family_data(1)
    states = [index_state(build_index(
        spec, x, generator=torch.Generator().manual_seed(0), device=d))
        for d in ("cpu", dev)]
    assert states[0]["meta"] == states[1]["meta"]
    for k, v in states[0]["arrays"].items():
        assert (v == states[1]["arrays"][k]).all(), (spec, k)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [64, 5000, 1 << 24])
def test_chunked_adc_scan_equals_one_lut_dist_call(dev, pairs, monkeypatch):
    """The PQ family's chunked scan (running top-k) equals one unchunked
    lut_dist call over every row, then one selection; ties included."""
    import repro_torch.core.pq as pq_mod
    from repro_torch.core.distances import smallest_k
    from repro_torch.kernels.lut_dist import lut_dist
    g = torch.Generator().manual_seed(3)
    n, m, nq = 7000, 8, 33
    lut = torch.randint(0, 4, (nq, m, 256), generator=g).float().to(dev)
    codes = torch.randint(0, 256, (n, m), generator=g,
                          dtype=torch.uint8).to(dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand(
        nq, -1).contiguous()
    whole = lut_dist(lut, codes, ids)
    wd, wp = smallest_k(whole, 20)
    monkeypatch.setattr(pq_mod, "SCAN_PAIRS", pairs)
    gd, gi = pq_mod.adc_scan(lut, codes, 20)
    assert torch.equal(gi, wp) and torch.equal(gd, wd)


@pytest.mark.cuda
def test_smallest_k_keeps_the_tie_rule_on_the_card(dev):
    from repro_torch.core.distances import smallest_k
    g = torch.Generator().manual_seed(4)
    d = torch.randint(0, 5, (300, 4000), generator=g).float()
    d[0, 100:] = float("inf")
    for k in (1, 10, 257):
        cv, cp = smallest_k(d, k)
        gv, gp = smallest_k(d.to(dev), k)
        assert torch.equal(gp.cpu(), cp) and torch.equal(gv.cpu(), cv)
        # lower position first among equal values
        same = cv[:, 1:] == cv[:, :-1]
        assert bool((cp[:, 1:][same] > cp[:, :-1][same]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["IVF4", "IVFPQ4x8", "HNSW8,EP4",
                                  "NSG12,EP4"])
def test_card_snapshot_loads_on_the_cpu(dev, spec, tmp_path):
    from repro_torch.core.index_api import build_index
    from repro_torch.core.persist import load_index, save_index
    x, q = _family_data(2)
    card = build_index(spec, x, device=dev)
    save_index(card, str(tmp_path / "snap"))
    cpu = load_index(str(tmp_path / "snap"), device="cpu")
    assert cpu.spec == spec and type(cpu) is type(card)
    dg, ig = card.search(q.to(dev), 10)
    dc, ic = cpu.search(q, 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)


# ------------------------------------ the sharded and out-of-core tier
_SHARDED_PARAMS = dict(pca_dim=32, antihub_keep=1.0, ep_clusters=4,
                       ef_search=32, graph_degree=12, build_knn_k=12,
                       build_candidates=24, knn_backend="exact",
                       finish_backend="host")


def _sharded_cpu():
    """A 2-shard ShardedIndex fit on a CPU mesh over the integer family
    data (PCA off), with its queries."""
    from repro_torch.core.distributed import ShardedIndex
    from repro_torch.core.pipeline import IndexParams
    from repro_torch.launch.mesh import make_host_mesh
    x, q = _family_data(5)
    mesh = make_host_mesh(model=2, devices=["cpu"] * 2)
    return ShardedIndex(IndexParams(**_SHARDED_PARAMS), mesh).fit(x), q


def _blocks(idx, s):
    a = idx.arrays
    return {"base": a.base.blocks[s], "neighbors": idx.struct_neighbors
            .blocks[s], "global_ids": a.global_ids.blocks[s],
            "centroids": a.centroids.blocks[s],
            "members": a.members.blocks[s],
            "base_norms": a.base_norms.blocks[s],
            "knn_ids": idx.knn_ids.blocks[s], "medoid": idx.medoids.blocks[s]}


@pytest.mark.cuda
def test_sharded_index_on_the_card_equals_the_cpu(dev):
    """The CPU fit's blocks placed on a mesh naming the card twice: search
    (beam_hops per shard) and reprune (derive_local: alpha_scan per block)
    equal the CPU's exactly on integer data."""
    import copy
    from dataclasses import replace
    from repro_torch.distributed.sharding import RowSharded
    from repro_torch.launch.mesh import make_host_mesh
    cpu, q = _sharded_cpu()
    mesh = make_host_mesh(model=2, devices=[dev] * 2)
    card = copy.copy(cpu)
    card.mesh, card._step = mesh, None

    def move(rs):
        return RowSharded(mesh, rs.blocks)

    a = cpu.arrays
    card.arrays = replace(a, **{f: move(getattr(a, f)) for f in (
        "base", "neighbors", "global_ids", "centroids", "members",
        "base_norms")}, pca_mean=a.pca_mean.to(dev),
        pca_comp=a.pca_comp.to(dev))
    card.struct_neighbors = card.arrays.neighbors
    card.knn_ids, card.medoids = move(cpu.knn_ids), move(cpu.medoids)
    dc, ic = cpu.search(q, 10)
    dg, ig = card.search(q.to(dev), 10)
    assert ig.is_cuda and torch.equal(ig.cpu(), ic)
    assert torch.equal(dg.cpu(), dc)
    rc, rg = cpu.reprune(alpha=1.2, degree=8), card.reprune(alpha=1.2,
                                                            degree=8)
    for bc, bg in zip(rc.arrays.neighbors.blocks, rg.arrays.neighbors.blocks):
        assert bg.is_cuda and torch.equal(bg.cpu(), bc)
    dc, ic = rc.search(q, 10)
    dg, ig = rg.search(q.to(dev), 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)


@pytest.mark.cuda
def test_streamed_index_on_the_card_equals_the_cpu(dev):
    """The same blocks through the card's pinned host-offload store
    (prefetch on a side stream, fetch waits on its event): search and
    reprune equal the CPU mesh index's; derived stores share every host
    buffer but the neighbors."""
    from repro_torch.core.distributed import StreamedShardedIndex
    cpu, q = _sharded_cpu()
    card = StreamedShardedIndex(cpu.params, 2, device=dev)
    for s in range(2):
        card.store.offload(s, _blocks(cpu, s))
    card._structural = card.store
    card.pca_mean = cpu.arrays.pca_mean.to(dev)
    card.pca_comp = cpu.arrays.pca_comp.to(dev)
    card._m, card.input_dim = cpu._m, cpu.dim
    assert all(t.is_pinned() for s in range(2)
               for t in card.store.peek_host(s).values())
    dc, ic = cpu.search(q, 10)
    dg, ig = card.search(q.to(dev), 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)
    rc, rg = cpu.reprune(alpha=1.2, degree=8), card.reprune(alpha=1.2,
                                                            degree=8)
    for s in range(2):
        host = rg.store.peek_host(s)
        assert host["neighbors"].is_pinned()
        assert torch.equal(host["neighbors"], rc.arrays.neighbors.blocks[s])
        assert host["base"] is card.store.peek_host(s)["base"]
    dc, ic = rc.search(q, 10)
    dg, ig = rg.search(q.to(dev), 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha,degree", [(1.0, 12), (1.2, 6)])
def test_derive_local_on_the_card_equals_the_cpu(dev, alpha, degree):
    from repro_torch.core.build import derive_local
    cpu, _ = _sharded_cpu()
    b = _blocks(cpu, 1)
    args = (b["base"], b["neighbors"], b["knn_ids"], int(b["medoid"][0]),
            b["global_ids"] >= 0)
    want = derive_local(*args, alpha=alpha, degree=degree, blk=64)
    got = derive_local(*(a.to(dev) if torch.is_tensor(a) else a
                         for a in args), alpha=alpha, degree=degree, blk=64)
    assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["Flat", "IVF4", "NSG12,EP4"])
def test_sharded_factory_on_the_card_equals_the_cpu(dev, spec):
    """ShardedFactoryIndex fit on the CPU, carried by its state to the card:
    searches equal exactly on integer data, a dead shard skipped alike."""
    from repro_torch.core.distributed import ShardedFactoryIndex
    from repro_torch.core.persist import index_from_state, index_state
    from repro_torch.serve.faults import FaultInjector
    x, q = _family_data(6)
    cpu = ShardedFactoryIndex(spec, 3, on_shard_error="skip",
                              device="cpu").fit(x)
    card = index_from_state(index_state(cpu), device=dev)
    assert card.device.type == "cuda"
    dc, ic = cpu.search(q, 10)
    dg, ig = card.search(q.to(dev), 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)
    for idx in (cpu, card):
        idx.subs[1] = FaultInjector(permanent_rate=1.0).wrap_index(
            idx.subs[1])
    dc, ic = cpu.search(q, 10)
    dg, ig = card.search(q.to(dev), 10)
    assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)
    assert card.degraded_shards == cpu.degraded_shards == 1


# -- the sharded tier's modes (bf16 rows, prenorm) of gather_dist and the
# f32 hop loop: the plain versions follow the kernels' lane order, so float
# data must match bit for bit

MODE_CASES = [("bf16", False), ("f32", True), ("bf16", True)]
MODE_IDS = ["bf16", "prenorm", "bf16+prenorm"]


def _mode_operands(db, mode):
    rows, prenorm = mode
    norms = (db * db).sum(-1) if prenorm else None      # of the f32 rows
    return (db.bfloat16() if rows == "bf16" else db), norms


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODE_CASES, ids=MODE_IDS)
@pytest.mark.parametrize("d", [600, 37, 1100, 8])
def test_gather_dist_modes(dev, mode, d):
    """Each mode on float data, chunked rows (D = 600, 8), scalar rows (D =
    37) and rows past the grouped path (D = 1100), aligned and misaligned
    bases, pads and ids past N: the plain version's bits; each launch
    counted under its mode."""
    g = torch.Generator().manual_seed(d + 17)
    n = 3000
    q = torch.randn((200, d), generator=g).to(dev)
    raw = torch.randn((n + 1, d), generator=g).to(dev)
    ids = torch.randint(-1, n + 20, (200, 32), generator=g,
                        dtype=torch.int32).to(dev)
    name = mode_of_case(mode)
    rows, prenorm = mode
    for offset in (0, 1):             # aligned rows, then one element off
        flat = raw.view(-1)
        rows32 = flat[offset:offset + n * d].view(n, d)
        norms = (rows32 * rows32).sum(-1) if prenorm else None
        buf = flat.bfloat16() if rows == "bf16" else flat
        db = buf[offset:offset + n * d].view(n, d)
        before = gather_dist_cuda.by_mode[name]
        got = gather_dist_cuda(q, db, ids, norms)
        assert gather_dist_cuda.by_mode[name] == before + 1
        assert torch.equal(got, gather_dist_ref(q, db, ids.clamp_max(n - 1),
                                                norms))
        assert bool(torch.isinf(got[ids < 0]).all())


def mode_of_case(mode):
    rows, prenorm = mode
    return {("bf16", False): "bf16", ("f32", True): "prenorm",
            ("bf16", True): "bf16+prenorm"}[(rows, prenorm)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODE_CASES, ids=MODE_IDS)
@pytest.mark.parametrize("d", [40, 37])
def test_hop_loop_modes_equal_their_plain_version(dev, mode, d):
    """The f32 loop in each mode against beam_hops_ref on float data, every
    output, from a pool seeded by gather_dist in the same mode, with and
    without patience; launches counted under the mode."""
    from repro_torch.core.beam_search import _seed_batched
    from repro_torch.kernels.beam_hop import beam_hops, beam_hops_cuda, \
        beam_hops_ref
    from repro_torch.kernels.gather_dist import gather_dist
    g = torch.Generator().manual_seed(d)
    n, nq, r, ef = 2000, 96, 12, 16
    data = torch.randn((n, d), generator=g).to(dev)
    q = torch.randn((nq, d), generator=g).to(dev)
    _, nbrs = knn_graph(data, r)
    nbrs[::7, r - 3:] = -1
    entry = torch.randint(0, n, (nq,), generator=g, dtype=torch.int32).to(dev)
    db, norms = _mode_operands(data, mode)
    state = _seed_batched(q, db, nbrs, entry, ef,
                          lambda q_, db_, ids: gather_dist(q_, db_, ids,
                                                           norms=norms))
    args = (nbrs, *state[:6], state[7], q, db)
    name = mode_of_case(mode)
    for patience in (None, 3):
        kw = dict(k=10, max_iters=40, max_steps=40, patience=patience,
                  eps=0.0)
        before = beam_hops_cuda.by_mode[name]
        got = beam_hops(*args, backend="cuda", norms=norms, **kw)
        assert beam_hops_cuda.by_mode[name] == before + 1
        want = beam_hops_ref(*args, norms=norms, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODE_CASES, ids=MODE_IDS)
def test_sharded_search_in_each_mode_equals_the_cpu(dev, mode):
    """beam_search with a bf16 base and/or norms: the fused loop on the
    card (one beam_hops launch) equals the plain fused loop on the CPU, ids
    and distances, on float data."""
    from repro_torch.kernels.beam_hop import beam_hops_cuda
    g = torch.Generator().manual_seed(3)
    data = torch.randn((3000, 48), generator=g)
    q = torch.randn((64, 48), generator=g)
    _, nbrs = knn_graph(data, 12)
    entry = torch.randint(0, 3000, (64,), generator=g, dtype=torch.int32)
    db, norms = _mode_operands(data, mode)
    kw = dict(ef=24, k=10, hop_backend="fused", norms=norms)
    n0 = beam_hops_cuda.launches
    d, i, _ = beam_search(q.to(dev), db.to(dev), nbrs.to(dev),
                          entry.to(dev), **dict(kw, norms=None if norms is
                                                None else norms.to(dev)))
    assert beam_hops_cuda.launches == n0 + 1
    dc, ic, _ = beam_search(q, db, nbrs, entry, **kw)
    assert torch.equal(i.cpu(), ic) and torch.equal(d.cpu(), dc)


@pytest.mark.cuda
def test_modes_the_kernels_cannot_take_raise(dev):
    """A row type other than f32 / bf16, norms of the wrong shape or type,
    and the one-hop kernel asked for a mode: each raises, nothing falls
    back to a plain version."""
    from repro_torch.kernels.beam_hop import beam_hop
    q = torch.randn((4, 16), device=dev)
    db = torch.randn((50, 16), device=dev)
    ids = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gather_dist_cuda(q, db.half(), ids)
    with pytest.raises(ValueError, match="norms"):
        gather_dist_cuda(q, db, ids, torch.ones(49, device=dev))
    with pytest.raises(TypeError, match="norms"):
        gather_dist_cuda(q, db, ids, torch.ones(50, device=dev).double())
    pool_i = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="one-hop kernel"):
        beam_hop(ids[:, 0], ids.new_zeros((50, 3)), pool_i,
                 torch.zeros((4, 8), device=dev), pool_i.bool(), q,
                 db.bfloat16())


# -- the dense LM (no kernel of the port: plain PyTorch on the card) ---------

def _lm_cfg(arch, layers=2):
    """The arch's full width and vocabulary at ``layers`` layers."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    return replace(get_arch(arch).config, n_layers=layers)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mistral-nemo-12b",
                                  "qwen3-32b"])
def test_lm_prefill_then_decode_equals_forward_on_the_card(dev, arch):
    """Full width, 2 layers, bf16: prefill 24 tokens into a 30-slot cache,
    decode 6 greedily; each step's logits against forward over the 30
    tokens: relative RMS difference <= 5% and the largest <= 25% of the
    largest |logit| (bf16 rounds at other places when the products take
    other shapes), the ids equal wherever forward's top two are further
    apart than twice the largest difference."""
    from repro_torch.models import transformer as T
    cfg = _lm_cfg(arch)
    model = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g,
                           device=dev, dtype=torch.int32)
    last, cache = T.prefill(model, cfg, prompt, max_len=30)
    rows, ids = [last[:, -1]], []
    for i in range(6):
        ids.append(rows[-1].argmax(-1).to(torch.int32))
        lg, cache = T.decode_step(model, cfg, ids[-1], cache, torch.full(
            (2,), 24 + i, dtype=torch.int32, device=dev))
        rows.append(lg)
    assert cache.length.tolist() == [30, 30]
    seq = torch.cat([prompt, torch.stack(ids, 1)], 1)
    with torch.no_grad():
        fwd, _ = T.forward(model, cfg, seq)
    got, want = torch.stack(rows, 1), fwd[:, 23:]
    err = (got - want).abs()
    assert float((got - want).norm() / want.norm()) <= 0.05
    assert float(err.max()) <= 0.25 * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) <= 2 * float(err.max())
    assert bool(((got.argmax(-1) == want.argmax(-1)) | tie).all())


@pytest.mark.cuda
def test_lm_decode_drops_the_write_past_the_cache_on_the_card(dev):
    """A prefill without max_len sizes the cache to the prompt; a decode
    at pos == S drops its write (JAX's out-of-bounds rule) with no device
    assert, moves the lengths, and gives the CPU's logits."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step
    cfg = get_arch("qwen3-32b").smoke_config
    model = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    pos = torch.tensor([12, 5], dtype=torch.int32)      # row 0 past the end
    out = {}
    for d in (torch.device("cpu"), dev):
        m = model.to(d)
        last, cache = lm_prefill_step(cfg)(m, toks.to(d))
        before = cache.a.clone()
        logits, cache = lm_decode_step(cfg)(m, last.argmax(-1).int(),
                                            cache, pos.to(d))
        torch.cuda.synchronize()
        assert cache.length.tolist() == [13, 6]
        assert torch.equal(cache.a[:, 0], before[:, 0])     # dropped
        assert not torch.equal(cache.a[:, 1], before[:, 1])
        out[d.type] = logits.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_lm_chunked_attention_equals_sdpa_on_the_card(dev):
    from repro_torch.models.layers import CHUNK_THRESHOLD, attention, sdpa
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, CHUNK_THRESHOLD + 100, 12, 128), generator=g,
                    device=dev)
    k, v = (torch.randn((1, CHUNK_THRESHOLD + 100, 2, 128), generator=g,
                        device=dev) for _ in range(2))
    with torch.no_grad():
        torch.testing.assert_close(attention(q, k, v, causal=True),
                                   sdpa(q, k, v, causal=True), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_lm_train_step_on_the_card_equals_the_cpu(dev):
    """One adamw(3e-4) step of the smoke config in float32 with two
    microbatches: the card's loss and gradient norm against the CPU's, and
    every parameter moved on both (a first Adam step moves an element by
    about lr * sign(g), so a gradient element near zero may step either
    way: the parameters are not compared)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    cfg = get_arch("qwen2-1.5b").smoke_config
    batch = lm_batch(torch.Generator().manual_seed(1), 4, 32, cfg.vocab_size)
    out = {}
    for d in (torch.device("cpu"), dev):
        model = T.init_params(torch.Generator().manual_seed(0), cfg).to(d)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = adamw(3e-4)
        step = make_train_step(loss_fn_for("lm", cfg), opt, microbatches=2)
        model, _, met = step(model, opt.init(model),
                             {k: v.to(d) for k, v in batch.items()})
        assert all(not torch.equal(p.detach(), before[n])
                   for n, p in model.named_parameters())
        out[d.type] = (float(met["loss"]), float(met["grad_norm"]))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert abs(a - b) <= 1e-5 * abs(b)


@pytest.mark.cuda
def test_lm_tensor_parallel_on_the_card_equals_unsharded(dev):
    """qwen2-1.5b's smoke config (vocabulary 512, so the lookup and head
    split) in float32, tensor-parallel over a (1, 2) mesh naming cuda:0
    twice: forward's logits, the loss and every gradient, and a prefill
    then 2 decode steps on a cache split on sequence (its one KV head does
    not divide 2), each equal to the unsharded model's on the card to
    rtol 1e-5 (atol 1e-5 of the compared tensor's largest magnitude)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import cache_split, shard_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    cfg = replace(get_arch("qwen2-1.5b").smoke_config, vocab_size=512)
    model = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    mesh = make_host_mesh(1, 2, devices=[dev] * 2)
    sm = shard_lm(model, mesh)
    assert cache_split(cfg, mesh) == "seq"
    toks = torch.randint(0, 512, (2, 16), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def close(got, want):
        scale = float(want.abs().max()) or 1.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)

    with torch.no_grad():
        close(T.forward(sm, cfg, toks, mesh=mesh)[0],
              T.forward(model, cfg, toks)[0])
    loss, _ = T.lm_loss(sm, cfg, batch, mesh=mesh)
    want, _ = T.lm_loss(model, cfg, batch)
    close(loss.detach(), want.detach())
    ps = dict(sm.named_parameters())
    got = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    ref = dict(zip(dict(model.named_parameters()), torch.autograd.grad(
        want, list(model.parameters()))))
    for name, d in sm.dims.items():
        g = got[f"shards.0.{name}"] if d is None else torch.cat(
            [got[f"shards.{s}.{name}"] for s in range(2)], dim=d)
        close(g, ref[name])
    lg, cache = T.prefill(sm, cfg, toks[:, :8], max_len=12, mesh=mesh)
    lw, cw = T.prefill(model, cfg, toks[:, :8], max_len=12)
    close(lg, lw)
    for i in range(2):
        tok = lw[:, -1].argmax(-1).int() if i == 0 else lw.argmax(-1).int()
        pos = torch.full((2,), 8 + i, dtype=torch.int32, device=dev)
        lg, cache = T.decode_step(sm, cfg, tok, cache, pos, mesh=mesh)
        lw, cw = T.decode_step(model, cfg, tok, cw, pos)
        close(lg, lw)



@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_moe_and_mla_tensor_parallel_on_the_card_equal_unsharded(dev, arch):
    """The smoke config (vocabulary 512; dispatch groups of 16 tokens at
    capacity factor 1.0, so pairs drop) in float32, tensor- and
    expert-parallel over a (1, 2) mesh naming cuda:0 twice: forward's
    logits and the loss, and a prefill then 2 decode steps (the MLA
    latent cache split on sequence), each equal to the unsharded model's
    on the card to rtol 1e-5 (atol 1e-5 of the compared tensor's largest
    magnitude); every MoE call's routed ids and dropped pairs equal."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import shard_lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = replace(get_arch(arch).smoke_config, vocab_size=512,
                  moe_group_size=16, moe_capacity_factor=1.0)
    model = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    mesh = make_host_mesh(1, 2, devices=[dev] * 2)
    sm = shard_lm(model, mesh)
    toks = torch.randint(0, 512, (4, 12), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    def close(got, want):
        scale = float(want.abs().max()) or 1.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)

    def same(got, want):
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert torch.equal(a["ids"], b["ids"])
            assert torch.equal(a["dropped"], b["dropped"])

    with torch.no_grad(), M.routing_log() as got_log:
        got = T.forward(sm, cfg, toks, mesh=mesh)[0]
    with torch.no_grad(), M.routing_log() as want_log:
        want = T.forward(model, cfg, toks)[0]
    close(got, want)
    same(got_log, want_log)
    assert sum(int(r["dropped"].sum()) for r in want_log) > 0
    close(T.lm_loss(sm, cfg, batch, mesh=mesh)[0].detach(),
          T.lm_loss(model, cfg, batch)[0].detach())
    with M.routing_log() as got_log:
        lg, cache = T.prefill(sm, cfg, toks[:, :8], max_len=12, mesh=mesh)
    with M.routing_log() as want_log:
        lw, cw = T.prefill(model, cfg, toks[:, :8], max_len=12)
    close(lg, lw)
    same(got_log, want_log)
    for i in range(2):
        tok = lw[:, -1].argmax(-1).int() if i == 0 else lw.argmax(-1).int()
        pos = torch.full((4,), 8 + i, dtype=torch.int32, device=dev)
        with M.routing_log() as got_log:
            lg, cache = T.decode_step(sm, cfg, tok, cache, pos, mesh=mesh)
        with M.routing_log() as want_log:
            lw, cw = T.decode_step(model, cfg, tok, cw, pos)
        close(lg, lw)
        same(got_log, want_log)

# -- MoE and MLA (no kernel of the port: plain PyTorch on the card) ----------

def _int_moe(dev, cfg, seed):
    """An MoE layer of ``cfg`` with small integer weights (exact products
    and sums on either device) and its integer input rows."""
    from repro_torch.models.moe import moe_init
    g = torch.Generator().manual_seed(seed)
    moe = moe_init(g, cfg)
    with torch.no_grad():
        for p in moe.parameters():
            p.copy_(torch.randint(-2, 3, p.shape, generator=g).float())
    x = torch.randint(-2, 3, (4, 16, cfg.d_model), generator=g).float()
    return moe, x


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [8.0, 0.5])
def test_lm_moe_layer_on_the_card_equals_the_cpu(dev, capacity):
    """deepseek-moe-16b's smoke layer with integer weights and inputs: the
    router's logits are exact integers, full of ties, so the routed ids,
    the per-expert counts and the kept pairs must equal the CPU's (the
    tie rule included), and at capacity factor 0.5 tokens drop. The
    output (a float product chain whose terms cancel) to rtol 1e-5 and
    atol 1e-5 of its largest magnitude (measured on an H100: 1.5e-3 of
    values ~1e3, ~1e-6 of the scale); the gradients of a
    fixed loss too, and a second backward on the card is bit-equal to
    the first (the dispatch and combine are gathers both ways: no float
    atomics)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as M
    cfg = replace(get_arch("deepseek-moe-16b").smoke_config,
                  moe_group_size=16, moe_capacity_factor=capacity)
    moe, x = _int_moe(dev, cfg, 3)
    def run(m, xd):
        y, aux = M.moe_apply(m, cfg, xd)
        weights = torch.arange(y.numel(), device=y.device).reshape(
            y.shape).remainder(7)
        loss = (y * weights).sum() * 1e-3 + aux
        return y, aux, torch.autograd.grad(loss, [xd, m.router, m.w_up])

    out = {}
    for d in (torch.device("cpu"), dev):
        m = moe.to(d)
        xd = x.to(d).requires_grad_()
        with M.routing_log() as log:
            y, aux, grads = run(m, xd)
        if d.type == "cuda":
            again = run(m, xd)[2]
            assert all(torch.equal(a, b) for a, b in zip(grads, again))
        out[d.type] = ([int(r["kept"]) for r in log],
                       [r["counts"].cpu() for r in log], y.detach().cpu(),
                       float(aux), [gg.cpu() for gg in grads])
    kept, counts, y, aux, grads = out["cuda"]
    assert kept == out["cpu"][0]
    assert all(torch.equal(a, b) for a, b in zip(counts, out["cpu"][1]))
    if capacity < 1:
        assert kept[0] < 64 * cfg.moe_top_k

    def close(a, b):        # the expert outputs cancel: atol of the scale
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    close(y, out["cpu"][2])
    assert abs(aux - out["cpu"][3]) <= 1e-6 * abs(out["cpu"][3])
    for a, b in zip(grads, out["cpu"][4]):
        close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["absorbed", "rebuilt"])
def test_lm_mla_decode_on_the_card_equals_the_cpu(dev, form):
    """deepseek-v2-236b's MLA at its published widths (d 5120, 128 heads,
    r 512, rd 64, q LoRA 1536) in float32: one decode step over a random
    latent cache of 2 x 512 positions, a write past the cache dropped; the
    card's output and cache against the CPU's, and the absorbed form
    against the rebuilt one on the card."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = replace(get_arch("deepseek-v2-236b").config, dtype="float32")
    p = L.mla_init(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    cc = torch.randn((2, 512, cfg.kv_lora_rank), generator=g)
    ckr = torch.randn((2, 512, cfg.qk_rope_head_dim), generator=g)
    pos = torch.tensor([300, 512], dtype=torch.int32)     # row 1: dropped
    valid = torch.tensor([301, 512], dtype=torch.int32)
    fns = {"absorbed": L.mla_decode_absorbed, "rebuilt": L.mla_decode}
    out = {}
    with torch.no_grad():
        for d in (torch.device("cpu"), dev):
            pd = p.to(d)
            cache = (cc.clone().to(d), ckr.clone().to(d))
            o, cache = fns[form](pd, cfg, x.to(d), pos.to(d), cache,
                                 valid.to(d))
            out[d.type] = (o.cpu(), cache[0].cpu(), cache[1].cpu())
            if d.type == "cuda":
                other = "rebuilt" if form == "absorbed" else "absorbed"
                o2, _ = fns[other](pd, cfg, x.to(d), pos.to(d),
                                   (cc.clone().to(d), ckr.clone().to(d)),
                                   valid.to(d))
                torch.testing.assert_close(o, o2, rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"][1][1], cc[1])          # dropped write
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# -- DimeNet: segment_sum and the one-id bag (the GNN's scatters and the
# gathers that train) --------------------------------------------------------

def _gnn_ids(g, t, s, dev):
    """t ids into s segments: a third -1 (padding), and one id taking
    10,000 of them (a hub's run, to one warp)."""
    ids = torch.randint(0, s, (t,), generator=g, dtype=torch.int32)
    ids[torch.rand((t,), generator=g) < 0.33] = -1
    ids[torch.randperm(t, generator=g)[:10_000]] = 5
    return ids.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 128])
def test_segment_sum_kernel(dev, d):
    """segment_sum on the card (the backward kernel, ids (T, 1)) equals its
    plain version bit for bit, -1 skipped, a 10,000-row run included; its
    gradient (the bag kernel) too; each launches its kernel once."""
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_backward_cuda, embedding_bag_backward_ref, \
        embedding_bag_ref, segment_sum
    g = torch.Generator().manual_seed(d)
    t, s = 40_000, 3_000
    ids = _gnn_ids(g, t, s, dev)
    data = torch.randn((t, d), generator=g).to(dev).requires_grad_(True)
    n0 = embedding_bag_backward_cuda.launches
    got = segment_sum(data, ids, s)
    assert embedding_bag_backward_cuda.launches == n0 + 1
    want = embedding_bag_backward_ref(data.detach(), ids[:, None], None,
                                      "sum", s)
    assert torch.equal(got.detach().view(torch.int32),
                       want.view(torch.int32))
    cot = torch.randn((s, d), generator=g).to(dev)
    n0 = embedding_bag_cuda.launches
    (grad,) = torch.autograd.grad(got, data, cot)
    assert embedding_bag_cuda.launches == n0 + 1
    assert torch.equal(grad, embedding_bag_ref(cot, ids[:, None], None,
                                               "sum"))
    assert not grad[ids < 0].any()
    cpu = segment_sum(data.detach().cpu(), ids.cpu(), s)
    assert torch.equal(cpu.view(torch.int32), got.detach().cpu().view(
        torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 128])
def test_one_id_bag_kernel(dev, d):
    """A bag of one id per row (table[ids], -1 a zero row) on the card
    equals its plain version bit for bit, and its gradient (the backward
    kernel, a 10,000-writer run on one row) too, as on the CPU."""
    from repro_torch.kernels.embedding_bag import embedding_bag, \
        embedding_bag_backward_cuda, embedding_bag_backward_ref, \
        embedding_bag_ref
    g = torch.Generator().manual_seed(10 + d)
    v, t = 3_000, 40_000
    ids = _gnn_ids(g, t, v, dev)[:, None].contiguous()
    table = torch.randn((v, d), generator=g).to(dev).requires_grad_(True)
    out = embedding_bag(table, ids)
    assert torch.equal(out.detach(), embedding_bag_ref(table.detach(), ids))
    cot = torch.randn((t, d), generator=g).to(dev)
    n0 = embedding_bag_backward_cuda.launches
    (grad,) = torch.autograd.grad(out, table, cot)
    assert embedding_bag_backward_cuda.launches == n0 + 1
    want = embedding_bag_backward_ref(cot, ids, None, "sum", v)
    assert torch.equal(grad.view(torch.int32), want.view(torch.int32))
    cpu = embedding_bag_backward_ref(cot.cpu(), ids.cpu(), None, "sum", v)
    assert torch.equal(grad.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
def test_dimenet_step_on_the_card_equals_the_cpu(dev):
    """The SMOKE DimeNet's loss and every gradient on the card against
    the CPU's on the same weights and padded batch (rtol 1e-5 on the
    loss, 1e-5 of each leaf's largest magnitude: the products sum in
    other orders), two runs on the card bit-equal, both bag kernels
    launched; then one adamw(1e-3) step moves every parameter."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graph_sampler import graph_to_device, \
        make_dimenet_batch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, \
        embedding_bag_backward_cuda
    from repro_torch.models import dimenet
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    cfg = get_arch("dimenet").smoke_config
    host = make_dimenet_batch(0, n_nodes=64, n_edges=128, n_triplets=512,
                              n_graphs=4)
    model = dimenet.init_params(torch.Generator().manual_seed(0), cfg)

    def loss_and_grads(m, graph):
        loss, _ = dimenet.loss_fn(m, cfg, graph)
        return [loss.detach()] + list(torch.autograd.grad(
            loss, list(m.parameters())))

    cpu = loss_and_grads(model, graph_to_device(host, "cpu"))
    card_model = dimenet.init_params(torch.Generator().manual_seed(0),
                                     cfg).to(dev)
    graph = graph_to_device(host, dev)
    n0 = (embedding_bag_cuda.launches, embedding_bag_backward_cuda.launches)
    card = loss_and_grads(card_model, graph)
    assert embedding_bag_cuda.launches > n0[0]
    assert embedding_bag_backward_cuda.launches > n0[1]
    again = loss_and_grads(card_model, graph)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(card, again))
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-5 * abs(float(cpu[0]))
    for a, b in zip(card[1:], cpu[1:]):
        scale = float(b.abs().max()) or 1.0
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * scale
    before = {n: p.detach().clone() for n, p in card_model.named_parameters()}
    opt = adamw(1e-3)
    step = make_train_step(loss_fn_for("gnn", cfg), opt)
    card_model, _, met = step(card_model, opt.init(card_model), graph)
    assert float(met["loss"]) == float(card[0])
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in card_model.named_parameters())


# -- the bag's grouping (bag_grouping: the plan of a flat id tensor) and the
# planned sum -------------------------------------------------------------

def _group_ids(g, n, v, kind):
    """n ids over v rows: random with a third padding, all pads, a
    10,000-member hub (or half of n), or ids past the table."""
    if kind == "pads":
        return torch.full((n,), -1, dtype=torch.int32)
    ids = torch.randint(0, v, (n,), generator=g, dtype=torch.int32)
    if kind == "past":
        ids[torch.rand((n,), generator=g) < 0.2] = v + 7
        ids[0] = 2 ** 31 - 1
    ids[torch.rand((n,), generator=g) < 0.33] = -1
    if kind == "hub":
        ids[torch.randperm(n, generator=g)[:min(10_000, n // 2)]] = v // 2
    return ids


def _assert_plan_equal(plan, want):
    u, n_valid = (int(x) for x in plan.count.cpu().tolist())
    assert [u, n_valid] == want.count.tolist()
    assert torch.equal(plan.order[:n_valid].cpu(), want.order)
    assert torch.equal(plan.rows[:u].cpu(), want.rows)
    assert torch.equal(plan.starts[:u + 1].cpu(), want.starts)


# n from none to 147 radix tiles of 2,048 ids (both sides of one tile),
# V from 1 to 2^24 (one radix pass to three)
GROUP_CASES = [(0, 5, "rand"), (1, 1, "rand"), (3_840, 128, "rand"),
               (2_048, 300, "hub"), (2_049, 7, "rand"),
               (8_192, 2 ** 24, "hub"), (8_193, 1, "rand"),
               (8_193, 300, "hub"), (20_000, 2, "pads"), (5_000, 7, "pads"),
               (40_000, 3_000, "hub"), (100_000, 2 ** 24, "past"),
               (7_000, 257, "past"), (300_000, 65_537, "rand")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,kind", GROUP_CASES)
def test_bag_grouping_kernel(dev, n, v, kind):
    """order, rows, starts and U equal the plain version's (a stable
    torch.sort) exactly, one launch a call (none for no ids), the same
    plan twice."""
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        bag_grouping_ref
    g = torch.Generator().manual_seed(n + v)
    ids = _group_ids(g, n, v, kind)
    n0 = bag_grouping_cuda.launches
    plan = bag_grouping_cuda(ids.to(dev), v)
    assert bag_grouping_cuda.launches == n0 + (n > 0)
    want = bag_grouping_ref(ids, v)
    _assert_plan_equal(plan, want)
    again = bag_grouping_cuda(ids.to(dev), v)
    _assert_plan_equal(again, want)


def _path_group_ids(g, name):
    """Ids of the grouping's four path shapes: DimeNet's agg (337,920
    triplets into 168,960 edges), node readout (168,960 edges, 57%
    padding, into 171,008 nodes), molecule's graph readout (3,840 nodes,
    31% padding, into 128 graphs) and the two-tower step (65,536 bags of
    32 over 14,010,368 rows)."""
    if name == "agg":
        return torch.randint(0, 168_960, (337_920,), generator=g,
                             dtype=torch.int32), 168_960
    if name == "node_readout":
        ids = torch.randint(0, 8_191, (168_960,), generator=g,
                            dtype=torch.int32)
        ids[torch.rand((168_960,), generator=g) < 0.57] = -1
        return ids, 171_008
    if name == "graph_readout":
        ids = torch.arange(3_840, dtype=torch.int32) // 30
        ids[torch.rand((3_840,), generator=g) < 0.31] = -1
        return ids, 128
    return torch.randint(0, 14_010_368, (65_536, 32), generator=g,
                         dtype=torch.int32), 14_010_368


PATH_GROUPS = ["agg", "node_readout", "graph_readout", "two_tower"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", PATH_GROUPS)
def test_bag_grouping_kernel_at_the_path_shapes(dev, name):
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        bag_grouping_ref
    ids, v = _path_group_ids(torch.Generator().manual_seed(3), name)
    _assert_plan_equal(bag_grouping_cuda(ids.to(dev), v),
                       bag_grouping_ref(ids, v))


# the planned sum at D = 1, 3 (scalar lanes), 128 and 256 (float4 lanes)
@pytest.mark.cuda
@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 3, 128, 256])
def test_planned_sum_kernel_store_and_add(dev, d, combiner, store):
    """The sum over a plan built once, in store mode into fresh zeros and
    in add mode into a gradient that is not zero (-0.0 in it and among
    the terms): bit-equal to the plain version, and the plan reused gives
    the same bits; one backward launch a call, no grouping launch."""
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        bag_grouping_ref, embedding_bag_backward_cuda, \
        embedding_bag_backward_ref
    g = torch.Generator().manual_seed(d + 2 * store)
    b, l, v = 3_000, 5, 700
    ids = _group_ids(g, b * l, v, "hub").reshape(b, l).to(dev)
    ids[7] = 3                                       # a bag all on one row
    grad = torch.randn((b, d), generator=g)
    grad[::5] = -0.0
    grad = grad.to(dev)
    w = torch.rand((b, l), generator=g).to(dev)
    w[1] = -0.0
    plan = bag_grouping_cuda(ids, v)
    want = embedding_bag_backward_ref(grad.cpu(), ids.cpu(), w.cpu(),
                                      combiner, v)
    rows = bag_grouping_ref(ids.cpu(), v).rows.long()
    base = torch.randn((v, d), generator=g)
    base[::3] = -0.0
    if store:
        start, expect = torch.zeros((v, d)), want
    else:
        start, expect = base, base.clone()
        expect[rows] = base[rows] + want[rows]
    n0 = (bag_grouping_cuda.launches, embedding_bag_backward_cuda.launches)
    outs = [embedding_bag_backward_cuda(grad, ids, w, combiner,
                                        start.to(dev), plan, store=store)
            for _ in range(2)]
    assert (bag_grouping_cuda.launches,
            embedding_bag_backward_cuda.launches) == (n0[0], n0[1] + 2)
    for out in outs:
        assert torch.equal(out.cpu().view(torch.int32),
                           expect.view(torch.int32))


@pytest.mark.cuda
def test_planned_sum_at_the_two_tower_path_shape(dev):
    """65,536 bags of 32 over 14,010,368 rows at D = 256, mean: the plan
    built inside the call and a prepared plan give the plain version's
    bits."""
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        embedding_bag_backward_cuda, embedding_bag_backward_ref
    g = torch.Generator(device=dev).manual_seed(9)
    v = 14_010_368
    ids = torch.randint(0, v, (65_536, 32), generator=g, device=dev,
                        dtype=torch.int32)
    grad = torch.randn((65_536, 256), generator=g, device=dev)
    want = embedding_bag_backward_ref(grad, ids, None, "mean", v)
    out = torch.zeros((v, 256), device=dev)
    embedding_bag_backward_cuda(grad, ids, None, "mean", out)
    assert torch.equal(out, want)
    out.zero_()
    embedding_bag_backward_cuda(grad, ids, None, "mean", out,
                                bag_grouping_cuda(ids, v), store=True)
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_card_backward_reaches_no_library_sort(dev, monkeypatch):
    """With torch.sort and torch.argsort raising, the bag's backward and
    segment_sum on the card run: the grouping is the port's own kernel."""
    from repro_torch.kernels.embedding_bag import bag_grouping, \
        bag_grouping_cuda, embedding_bag, embedding_bag_backward_cuda, \
        segment_sum

    def refuse(*args, **kwargs):
        raise AssertionError("a library sort on the card path")
    g = torch.Generator().manual_seed(12)
    ids = _group_ids(g, 30_000, 900, "hub").to(dev)
    table = torch.randn((900, 64), generator=g).to(dev).requires_grad_(True)
    data = torch.randn((30_000, 64), generator=g).to(dev)
    out = embedding_bag(table, ids[:, None].contiguous())
    plan = bag_grouping(ids, 900)
    n0 = (bag_grouping_cuda.launches, embedding_bag_backward_cuda.launches)
    with monkeypatch.context() as m:
        m.setattr(torch, "sort", refuse)
        m.setattr(torch, "argsort", refuse)
        m.setattr(torch.Tensor, "sort", refuse)
        m.setattr(torch.Tensor, "argsort", refuse)
        (grad,) = torch.autograd.grad(out, table,
                                      torch.ones_like(out))
        summed = segment_sum(data, ids, 900, plan)
        torch.cuda.synchronize()
    assert (bag_grouping_cuda.launches,
            embedding_bag_backward_cuda.launches) == (n0[0] + 1, n0[1] + 2)
    assert grad.shape == table.shape and summed.shape == (900, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("graphs", [4, 1])
def test_dimenet_step_groups_once_per_id_array(dev, graphs):
    """A SMOKE DimeNet loss and gradient on the card: one grouping per id
    array (src, dst, t_kj, t_ji, z, and the graph ids with several
    graphs) and 3 n_blocks + 2 backward launches, one more for z's gather
    and one for the graph readout (22 with the published config's 6
    blocks); the planned step's bits equal an unplanned one's."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graph_sampler import graph_to_device, \
        make_dimenet_batch
    from repro_torch.kernels.embedding_bag import bag_grouping_cuda, \
        embedding_bag_backward_cuda
    from repro_torch.models import dimenet
    cfg = get_arch("dimenet").smoke_config
    host = make_dimenet_batch(0, n_nodes=64, n_edges=128, n_triplets=512,
                              n_graphs=graphs)
    graph = graph_to_device(host, dev)
    model = dimenet.init_params(torch.Generator().manual_seed(0),
                                cfg).to(dev)

    def loss_and_grads():
        loss, _ = dimenet.loss_fn(model, cfg, graph)
        return [loss.detach()] + list(torch.autograd.grad(
            loss, list(model.parameters())))
    n0 = (bag_grouping_cuda.launches, embedding_bag_backward_cuda.launches)
    planned = loss_and_grads()
    extra = 1 + (graphs > 1)
    assert (bag_grouping_cuda.launches - n0[0],
            embedding_bag_backward_cuda.launches - n0[1]) == (
        4 + extra, 3 * cfg.n_blocks + 2 + extra)
    kept = dimenet.bag_grouping
    dimenet.bag_grouping = lambda ids, rows: None
    try:
        bare = loss_and_grads()
    finally:
        dimenet.bag_grouping = kept
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(planned, bare))


# -- the dry run's cost records: the card's equal the meta branch's --------

def _costs_of(fn, *args):
    from repro_torch.analysis.op_costs import CostCounter
    with CostCounter() as c:
        out = fn(*args)
    d = c.per_device()
    return out, dict(d.op_counts), d.total_flops, d.bytes, c.peak_bytes


def _on_meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _same_costs(card, meta):
    out_c, counts_c, f_c, b_c, _ = card
    out_m, counts_m, f_m, b_m, _ = meta
    assert counts_c == counts_m and f_c == f_m and b_c == b_m
    outs = lambda o: [o] if isinstance(o, torch.Tensor) else list(o)
    assert [(t.shape, t.dtype) for t in outs(out_c)] == \
        [(t.shape, t.dtype) for t in outs(out_m)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["search", "build_knn", "tc", "tile",
                                  "small"])
def test_cost_record_card_equals_meta_ann(dev, case):
    """gather_dist, beam_hops (the fixed-beam search's 256 hops) and
    l2topk at the dry run's ANN shapes (a 64-query shard of search_300k;
    build_knn's 4096 x 300k; the other variants' shapes): the same ops,
    kernel records, FLOPs and bytes on the card as on meta."""
    from repro_torch.kernels.beam_hop import beam_hops
    from repro_torch.kernels.gather_dist import gather_dist
    from repro_torch.kernels.l2topk import l2_topk
    g = torch.Generator().manual_seed(7)
    if case == "search":
        q, ef, r, n, d = 64, 64, 32, 18_750, 600
        args = (torch.randint(0, n, (n, r), generator=g, dtype=torch.int32),
                torch.full((q, ef), -1, dtype=torch.int32),
                torch.full((q, ef), float("inf")),
                torch.zeros((q, ef), dtype=torch.bool),
                *(torch.zeros((q,), dtype=torch.int32) for _ in range(4)),
                torch.randn(q, d, generator=g), torch.randn(n, d, generator=g))
        args[1][:, 0] = 0
        args[2][:, 0] = 1.0

        def fn(*a):
            return (gather_dist(a[8], a[9], a[1][:, :1].contiguous()),
                    *beam_hops(*a, k=10, max_iters=256, max_steps=256))
        card = [t.to(dev) for t in args]
    else:
        q, n, d, k = {"build_knn": (4096, 300_000, 600, 33),
                      "tc": (256, 4096, 64, 16),
                      "tile": (7, 3000, 600, 1),
                      "small": (300, 256, 2, 1)}[case]
        args = (torch.randn(q, d, generator=g), torch.randn(n, d, generator=g))

        def fn(a, b):
            return l2_topk(a, b, k)
        card = [t.to(dev) for t in args]
    got = _costs_of(fn, *card)
    torch.cuda.synchronize()
    _same_costs(got, _costs_of(fn, *(_on_meta(t) for t in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["two_tower_bag", "dimenet_step"])
def test_cost_record_card_equals_meta_bags(dev, path):
    """The bag, its backward and its grouping at their path shapes (a
    two-tower batch of 512 bags of 32 over 1M rows, mean; a DimeNet
    minibatch_lg-sized segment sum and one-id bag through autograd): the
    same records on the card as on meta."""
    from repro_torch.kernels.embedding_bag import bag_grouping, \
        embedding_bag, segment_sum
    g = torch.Generator().manual_seed(3)
    if path == "two_tower_bag":
        v, d, b, l = 1 << 20, 256, 512, 32
        table = torch.randn(v, d, generator=g)
        ids = torch.randint(-1, v, (b, l), generator=g, dtype=torch.int32)

        def fn(t, i):
            t = t.requires_grad_()
            out = embedding_bag(t, i, combiner="mean")
            out.sum().backward()
            return out, t.grad
        args = (table, ids)
    else:
        e, n, d = 168_960, 171_008, 128
        data = torch.randn(e, d, generator=g)
        seg = torch.randint(-1, n, (e,), generator=g, dtype=torch.int32)

        def fn(x, s):
            x = x.requires_grad_()
            plan = bag_grouping(s, n)
            out = segment_sum(x, s, n, plan)
            back = embedding_bag(out, s[:, None], plan=None)
            (out.sum() + back.sum()).backward()
            return out, back, x.grad
        args = (data, seg)
    got = _costs_of(fn, *(t.to(dev) for t in args))
    torch.cuda.synchronize()
    _same_costs(got, _costs_of(fn, *(_on_meta(t) for t in args)))


@pytest.mark.cuda
def test_grouping_scratch_words_match_the_library(dev):
    """The meta branch's Python count of the grouping's scratch equals the
    C library's."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        grouping_scratch_words
    lib = cuda_lib.library()
    for n in (0, 1, 2047, 2048, 2049, 337_920, 2_097_152):
        assert lib.bag_grouping_scratch_words(n) == grouping_scratch_words(n)
