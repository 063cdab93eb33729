"""The port's cost analysis (``repro_torch.analysis``) against the
reference's: the per-op counter against ``hlo_costs.analyze_module`` on
the compiled HLO, ``lm_model_flops``, the hop byte model, and each
kernel wrapper's meta branch (outputs shaped as its plain version's, the
cost its card branch records)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: import order)
import repro.configs as RC
from repro.analysis import hop_traffic as R_HT
from repro.analysis.hlo_costs import analyze_module
from repro.analysis.roofline import lm_model_flops as ref_lm_model_flops

from repro_torch.analysis import hop_traffic as HT
from repro_torch.analysis.op_costs import CostCounter, loop, stand_in
from repro_torch.analysis.roofline import analyze, hbm_fit, lm_model_flops
from repro_torch.configs import get_arch, reduced_lm

META = torch.device("meta")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def _count(fn, *args, **kw):
    with CostCounter(**kw) as c:
        out = fn(*args)
    return c, out


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# -------------------------------------------- the counter vs hlo_costs
def test_product_flops_equal_hlo_costs():
    mc = analyze_module(_compile(
        lambda a, b: a @ b, jax.ShapeDtypeStruct((256, 128), jnp.float32),
        jax.ShapeDtypeStruct((128, 64), jnp.float32)).as_text())
    c, out = _count(lambda a, b: a @ b, _meta((256, 128)), _meta((128, 64)))
    assert out.shape == (256, 64) and out.is_meta
    assert c.per_device().total_flops == mc.flops == 2 * 256 * 128 * 64
    # operands read and the result written once, as hlo_costs counts a dot
    assert c.per_device().bytes == mc.hbm_bytes


def test_batched_product_flops_equal_hlo_costs():
    mc = analyze_module(_compile(
        lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
        jax.ShapeDtypeStruct((4, 32, 64), jnp.float32),
        jax.ShapeDtypeStruct((4, 64, 16), jnp.float32)).as_text())
    c, _ = _count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                  _meta((4, 32, 64)), _meta((4, 64, 16)))
    assert c.per_device().total_flops == mc.flops == 2 * 4 * 32 * 64 * 16


@pytest.mark.parametrize("n", [1, 2, 8])
def test_loop_of_products(n):
    """The reference counts a scan body times its trip count; the port's
    eager loop dispatches every trip and counts each: equal dot FLOPs.
    ``op_costs.loop`` (one meta trip counted n times) gives the same."""
    def ref(w, x):
        def body(x, _):
            return x @ w, None
        return jax.lax.scan(body, x, None, length=n)[0]
    mc = analyze_module(_compile(
        ref, jax.ShapeDtypeStruct((128, 128), jnp.float32),
        jax.ShapeDtypeStruct((4, 128), jnp.float32)).as_text())

    def eager(w, x):
        for _ in range(n):
            x = x @ w
        return x

    def looped(w, x):
        with loop(n, x) as trips:
            for _ in range(trips):
                x = x @ w
        return x
    c1, _ = _count(eager, _meta((128, 128)), _meta((4, 128)))
    c2, _ = _count(looped, _meta((128, 128)), _meta((4, 128)))
    assert c1.per_device().total_flops == mc.flops == 2 * 4 * 128 * 128 * n
    assert c2.per_device().total_flops == c1.per_device().total_flops
    assert c2.per_device().bytes == c1.per_device().bytes


def test_gather_bytes_not_whole_operand():
    c, _ = _count(lambda t, i: t[i], _meta((100000, 64)),
                  _meta((8,), torch.int64))
    b = c.per_device().bytes
    assert b == 8 * 8 + 2 * 8 * 64 * 4        # indices + rows read, written
    mc = analyze_module(_compile(
        lambda t, i: t[i], jax.ShapeDtypeStruct((100000, 64), jnp.float32),
        jax.ShapeDtypeStruct((8,), jnp.int32)).as_text())
    assert mc.hbm_bytes < 100000 * 64 * 4 / 10 and b < 100000 * 64 * 4 / 10


def test_scatter_counts_the_update_and_views_are_free():
    def f(t, i, u):
        v = t.view(-1).view(t.shape)              # views: no bytes
        return v.index_put_((i,), u)
    c, _ = _count(f, _meta((100000, 64)), _meta((8,), torch.int64),
                  _meta((8, 64)))
    assert c.per_device().bytes == 8 * 8 + 8 * 64 * 4
    assert c.per_device().op_counts["view"] == 2


def test_memory_peak_and_outside_split():
    """Live bytes rise by each new result and fall when it dies; the work
    outside any shard is divided by ``outside_split``."""
    def f(x):
        y = x * 2.0                              # 4 MB
        z = y + 1.0                              # 8 MB live
        del y
        return z.sum()
    c, _ = _count(f, _meta((1024, 1024)), outside_split=4)
    assert c.peak_bytes == 2 * 4 * 1024 * 1024 / 4
    assert c.per_device().bytes == c.common.bytes / 4


def test_stand_in_and_shards():
    """A shard's forward and backward ops count as that device's; a
    stand-in merge is free and hands the first copy its gradient."""
    from repro_torch.analysis.op_costs import in_shard
    w = _meta((64, 64)).requires_grad_()
    with CostCounter() as c:
        y = in_shard((0, 0), lambda x: x @ w, _meta((8, 64)))
        z = stand_in(y, 4)
        assert z.shape == (32, 64)
        z.sum().backward()
    shard = c.shards[(0, 0)]
    assert shard.op_counts["mm"] == 2            # forward + dW
    assert c.common.op_counts.get("mm", 0) == 0


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-32b",
                                  "mistral-nemo-12b"])
def test_reduced_lm_train_step_flops_match_reference(arch):
    """A reduced dense LM's train step: the counter's FLOPs on meta
    against hlo_costs on the reference's compiled step (one CPU device).
    Products are exact on both sides, reductions one FLOP an element; the
    measured gap is +0.47% to +0.49% (the three configs), held to 1%. (An
    MoE config's is not held: the reference dispatches by one-hot
    products, which count as dots, the port by row gathers: 22% fewer
    FLOPs at deepseek-moe-16b's reduced config.)"""
    from repro.models import transformer as r_transformer
    from repro.optim import adamw as r_adamw
    from repro.train.train_step import loss_fn_for as r_loss_fn_for
    from repro.train.train_step import make_train_step as r_make
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    rcfg = reduced_lm(RC.get_arch(arch).config)
    cfg = reduced_lm(get_arch(arch).config)
    b, s = 4, 64
    params = jax.eval_shape(lambda: r_transformer.init_params(
        jax.random.PRNGKey(0), rcfg))
    opt = r_adamw(3e-4)
    state = jax.eval_shape(opt.init, params)
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    step = r_make(r_loss_fn_for("lm", rcfg), opt)
    mc = analyze_module(_compile(step, params, state,
                                 {"tokens": tok, "labels": tok}).as_text())
    model = transformer.init_params(torch.Generator().manual_seed(0),
                                    cfg, device="meta")
    popt = adamw(3e-4)
    pstep = make_train_step(loss_fn_for("lm", cfg), popt)
    t = _meta((b, s), torch.int32)
    c, _ = _count(pstep, model, popt.init(model),
                  {"tokens": t, "labels": t})
    got = c.per_device().total_flops
    assert abs(got - mc.flops) / mc.flops < 0.01, (got, mc.flops)


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen2-1.5b",
                                  "mistral-nemo-12b", "deepseek-v2-236b",
                                  "deepseek-moe-16b"])
def test_lm_model_flops_equal(arch):
    spec, ref = get_arch(arch), RC.get_arch(arch)
    for name, shape in spec.shapes.items():
        assert lm_model_flops(spec.config, shape, shape.kind) == \
            ref_lm_model_flops(ref.config, ref.shape(name), shape.kind)


def test_roofline_terms_and_fit():
    c, _ = _count(lambda a, b: a @ b, _meta((4096, 4096), torch.bfloat16),
                  _meta((4096, 4096), torch.bfloat16))
    rep = analyze(c.per_device(), arch="t", shape="s", mesh_desc="1",
                  n_devices=1, model_flops=2 * 4096 ** 3,
                  arg_bytes=2 * 4096 * 4096 * 2)
    assert rep.flops_per_device == 2 * 4096 ** 3
    assert rep.compute_s == pytest.approx(2 * 4096 ** 3 / 989e12)
    assert rep.memory_s == pytest.approx(3 * 4096 * 4096 * 2 / 3.35e12)
    assert rep.bottleneck == "compute" and rep.useful_ratio == 1.0
    assert hbm_fit(rep) and not hbm_fit(rep, budget_bytes=1e6)


# ---------------------------------------------------------- hop traffic
@pytest.mark.parametrize("backend,m", [("f32", 0), ("pq", 0), ("pq", 300),
                                       ("int8", 600)])
def test_hop_traffic_compulsory_and_staged_equal_reference(backend, m):
    for ef, r, d in ((64, 32, 600), (32, 16, 128)):
        ref = R_HT.staged_hop_traffic(ef, r, d, backend, m)
        port = HT.staged_hop_traffic(ef, r, d, backend, m)
        assert (port.compulsory, port.spilled) == (ref.compulsory,
                                                   ref.spilled)
        assert HT.fused_hop_traffic(ef, r, d, backend, m).compulsory == \
            R_HT.fused_hop_traffic(ef, r, d, backend, m).compulsory


def test_fused_loop_spill_is_per_search():
    one = HT.fused_hop_traffic(64, 32, 600, hops=1)
    many = HT.fused_hop_traffic(64, 32, 600, hops=256)
    assert one.spilled == 2 * 64 * 9 + 37 and many.spilled == one.spilled \
        / 256
    # a 600-d bf16 row takes 38 sectors, an f32 one 75 exactly
    assert HT.fused_loop_bytes(1, 1, 64, 32, 600, row_bytes=2) - \
        HT.fused_loop_bytes(1, 0, 64, 32, 600, row_bytes=2) == \
        32 * 38 * 32 + 128
    assert HT.fused_loop_bytes(1, 1, 64, 32, 600) - HT.fused_loop_bytes(
        1, 0, 64, 32, 600) == 32 * 600 * 4 + 128


def test_traversal_savings_report_equals_reference():
    """On a port search's stats, the staged report equals the
    reference's; the fused one prices the per-search spill."""
    from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
    rng = np.random.default_rng(0)
    data = rng.normal(size=(600, 16)).astype(np.float32)
    idx = TunedGraphIndex(IndexParams(pca_dim=16, ep_clusters=4,
                                      graph_degree=8, build_knn_k=8,
                                      build_candidates=16),
                          device="cpu").fit(data)
    idx.search(data[:32], 10, ef=16, patience=2)
    stats = idx.search_stats()
    idx.search(data[:32], 10, ef=16)
    base = idx.search_stats()
    for kw in ({}, {"baseline_stats": base}):
        assert HT.traversal_savings_report(stats, 16, 8, 16, **kw) == \
            R_HT.traversal_savings_report(stats, 16, 8, 16, **kw)
    fused = HT.traversal_savings_report(stats, 16, 8, 16,
                                        hop_backend="fused")
    assert fused["bytes_per_hop"] < HT.traversal_savings_report(
        stats, 16, 8, 16)["bytes_per_hop"]
    with pytest.raises(ValueError):
        HT.traversal_savings_report(stats, 16, 8, 16, hop_backend="x")


# ------------------------------------------------- kernels' meta branches
def _meta_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def _kernel_cost(c, name):
    d = c.per_device()
    return d.op_counts[name], d.op_flops.get(name, 0.0), d.op_bytes[name]


def test_gather_dist_meta_branch():
    from repro_torch.kernels.gather_dist import gather_dist
    from repro_torch.kernels.gather_dist.gather_dist import cost
    g = torch.Generator().manual_seed(0)
    q, db = torch.randn(5, 12, generator=g), torch.randn(40, 12, generator=g)
    ids = torch.randint(-1, 40, (5, 7), generator=g, dtype=torch.int32)
    want = gather_dist(q, db, ids)
    c, got = _count(gather_dist, _meta_like(q), _meta_like(db),
                    _meta_like(ids))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _kernel_cost(c, "gather_dist") == (1, *cost(5, 7, 12, 4, False))


def test_l2topk_meta_branch():
    from repro_torch.kernels.l2topk import l2_topk
    from repro_torch.kernels.l2topk.l2topk import cost, variant_for
    for nq, n, d, k in ((4096, 300_000, 600, 33), (3, 50, 8, 10),
                        (2, 5, 4, 9)):
        q = torch.zeros((min(nq, 4), d))
        db = torch.zeros((min(n, 64), d))
        c, (dm, im) = _count(l2_topk, _meta((nq, d)), _meta((n, d)), k)
        kk = min(k, n)
        assert dm.shape == im.shape == (nq, kk)
        assert (dm.dtype, im.dtype) == (torch.float32, torch.int32)
        wd, wi = l2_topk(q, db, kk if kk <= db.shape[0] else 1)
        assert (wd.dtype, wi.dtype) == (dm.dtype, im.dtype)
        f, b, dt = cost(nq, n, d, kk, variant_for(nq, n, d, kk))
        assert _kernel_cost(c, "l2topk") == (1, f, b)
        assert dt in c.per_device().flops


def test_beam_hops_meta_branch():
    """The loop's meta branch: the 9 outputs of ``beam_hops_ref``, and the
    cost of ``max_steps`` hops for every lane."""
    from repro_torch.kernels.beam_hop import beam_hops
    from repro_torch.kernels.beam_hop.beam_hop import hops_cost
    q, ef, r, n, d = 6, 8, 4, 50, 16
    g = torch.Generator().manual_seed(0)
    args = (torch.randint(0, n, (n, r), generator=g, dtype=torch.int32),
            torch.full((q, ef), -1, dtype=torch.int32),
            torch.full((q, ef), float("inf")),
            torch.zeros((q, ef), dtype=torch.bool),
            *(torch.zeros((q,), dtype=torch.int32) for _ in range(4)),
            torch.randn(q, d, generator=g), torch.randn(n, d, generator=g))
    args[1][:, 0] = 0
    args[2][:, 0] = 1.0
    kw = dict(k=4, max_iters=12, max_steps=12)
    want = beam_hops(*args, **kw)
    c, got = _count(lambda *a: beam_hops(*a, **kw),
                    *(_meta_like(a) for a in args))
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert _kernel_cost(c, "beam_hops") == (
        1, *hops_cost(q, 12, ef, r, d, 0, 4, False))
    with pytest.raises(NotImplementedError):
        beam_hops(*(_meta_like(a) for a in args[:8]),
                  _meta((q, d // 2, 16)), _meta((n, d // 2), torch.uint8),
                  "pq", **kw)


def test_bag_kernels_meta_branches():
    """The bag, its grouping and its backward (through autograd, and
    ``segment_sum``): outputs shaped as the plain versions', plans at the
    card's bound, the costs the card branch records."""
    from repro_torch.kernels.embedding_bag import bag_grouping, \
        embedding_bag, segment_sum
    from repro_torch.kernels.embedding_bag.embedding_bag import \
        backward_cost, bag_cost, grouping_cost
    v, d, b, l = 300, 16, 9, 5
    g = torch.Generator().manual_seed(0)
    table = torch.randn(v, d, generator=g)
    ids = torch.randint(-1, v, (b, l), generator=g, dtype=torch.int32)
    want = embedding_bag(table, ids, combiner="mean")
    tm = _meta_like(table).requires_grad_()
    with CostCounter() as c:
        out = embedding_bag(tm, _meta_like(ids), combiner="mean")
        out.sum().backward()
    assert out.shape == want.shape and out.dtype == want.dtype
    assert tm.grad.shape == table.shape
    assert _kernel_cost(c, "embedding_bag") == (1, *bag_cost(b, l, d, 4,
                                                             False))
    assert _kernel_cost(c, "bag_grouping") == (1, *grouping_cost(b * l, v))
    assert _kernel_cost(c, "embedding_bag_backward") == (
        1, *backward_cost(b, l, d, v, False, True))
    with CostCounter() as c:
        plan = bag_grouping(_meta_like(ids), v)
    cap = min(b * l, v)
    assert (plan.order.shape, plan.rows.shape, plan.starts.shape) == \
        ((b * l,), (cap,), (cap + 1,))
    data = torch.randn(40, d, generator=g)
    seg = torch.randint(-1, 7, (40,), generator=g, dtype=torch.int32)
    with CostCounter() as c:
        s = segment_sum(_meta_like(data), _meta_like(seg), 7)
    assert s.shape == segment_sum(data, seg, 7).shape
    assert _kernel_cost(c, "embedding_bag_backward") == (
        1, *backward_cost(40, 1, d, 7, False, True))


def test_kernels_without_meta_branch_raise():
    from repro_torch.kernels.lut_dist import lut_dist
    from repro_torch.kernels.topk_merge import topk_pool
    with pytest.raises(NotImplementedError, match="meta"):
        lut_dist(_meta((4, 3, 16)), _meta((10, 3), torch.uint8),
                 _meta((4, 2), torch.int32))
    with pytest.raises(NotImplementedError, match="meta"):
        topk_pool(_meta((4, 6)), _meta((4, 6), torch.int32), 3)
