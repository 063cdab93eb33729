"""The port's DimeNet (``models/dimenet.py``) and its scatters against the
reference's, on the CPU, at dimenet's ``SMOKE`` config on graphs of at
most 96 nodes.

The bases to rtol 1e-6. ``segment_sum`` and the one-id bag (the gathers
that train) against ``jax.ops.segment_sum`` and ``take``, and their
gradients; padding passed as -1 gives the bits of the reference's
clamped, masked form. ``forward`` (both outputs) and ``loss_fn`` on
carried, perturbed weights in four graph variants (``z`` and ``x``, graph
and node targets, several graphs and one, a fan-out sampled batch with
padded nodes) to rtol 1e-5 / atol 1e-5 of each tensor's scale; one
``adamw(1e-3)`` step on the reference's gradients to rtol 1e-5 / atol
1e-6 of each leaf's scale; gradients against ``jax.value_and_grad`` to
atol 4e-6 of a leaf's scale (the two packages' float32 rounding, each
within 3.4e-6 of a float64 run, which the port is held to as well). The
backward pass adds with no float atomics outside the bag kernels' plain
versions, and the entry points take the gnn id. Besides, the host side of
``chip_smoke.py``'s DimeNet checks: the float64 yardstick on a run's own
bases and ReLU masks, and the kernel cases' ids.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import graph_sampler as JG
from repro.models import dimenet as JD
from repro.optim import adamw as jax_adamw
from repro_torch.carry import gnn_params_from_jax, named_from_jax, \
    param_name
from repro_torch.configs import get_arch, list_archs
from repro_torch.data import graph_sampler as PG
from repro_torch.data.graph_sampler import graph_to_device
from repro_torch.kernels.embedding_bag import embedding_bag, segment_sum
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import dimenet as D
from repro_torch.optim import adamw
from repro_torch.train.train_step import loss_fn_for, make_train_step

RTOL, ATOL = 1e-5, 1e-5          # forward and loss, of the tensor's scale
# Gradients: the reference's own float32 gradients lie up to 3.2e-6 of a
# leaf's scale from a float64 evaluation of the same function on these
# graphs, and the port's up to 3.4e-6 (reorderings of the products' sums
# and the readouts' cancellations); test_gradients_are_near_float64 holds
# the port to that. The optimizer step on equal gradients: 1e-6.
GRAD_RTOL, GRAD_ATOL = 1e-5, 4e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
CPU = torch.device("cpu")
CFG = jax_get_arch("dimenet").smoke_config
FEAT = 8
VARIANTS = {
    "z-graphs": dict(seed=0, n_nodes=48, n_edges=96, n_triplets=256,
                     n_graphs=4),
    "x-nodes": dict(seed=1, n_nodes=40, n_edges=96, n_triplets=200,
                    d_feat=FEAT, node_targets=True),
    "z-one-graph": dict(seed=2, n_nodes=30, n_edges=64, n_triplets=256),
    "sampled": "sampled",
}
SAMPLED = dict(n_nodes=96, n_edges=192, n_triplets=384, d_feat=FEAT,
               batch_nodes=8, fanout=(3, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    """rtol, and atol times the largest magnitude of ``want``."""
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=rtol, atol=atol * scale, **kw)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        spread = float(a.std()) or 1.0
        return jnp.asarray(a + (rng.standard_normal(a.shape) * 0.1
                                * spread).astype(np.float32))
    return jax.tree.map(move, tree)


def _graph(name):
    kw = VARIANTS[name]
    if kw == "sampled":
        return JG.sampled_dimenet_batch(
            3, JShapeConfig("sampled", "train", **SAMPLED), base_nodes=64,
            base_degree=4)
    return JG.make_dimenet_batch(**kw)


@pytest.fixture(scope="module")
def cases():
    """Per variant: the numpy graph, the reference's perturbed params, the
    port's model over them, and the reference's (forward, loss, grads),
    each variant compiled once."""
    out = {}
    for i, name in enumerate(VARIANTS):
        g = _graph(name)
        d_feat = g["x"].shape[1] if "x" in g else 0
        jp = _perturbed(JD.init_params(jax.random.PRNGKey(i), CFG, d_feat),
                        10 + i)
        jgraph = {k: jnp.asarray(v) for k, v in g.items()}

        def ref(p, gr):
            fwd = JD.forward(p, CFG, gr)
            (loss, _), grads = jax.value_and_grad(JD.loss_fn, has_aux=True)(
                p, CFG, gr)
            return fwd, loss, grads
        fwd, loss, grads = jax.jit(ref)(jp, jgraph)
        out[name] = dict(g=g, jp=jp, model=gnn_params_from_jax(jp, CFG, CPU),
                         fwd=fwd, loss=loss, grads=grads)
    return out


def _tgraph(case):
    return graph_to_device(case["g"], CPU)


# -- configs and init ------------------------------------------------------

def test_config_registry_and_shapes():
    spec, ref = get_arch("dimenet"), jax_get_arch("dimenet")
    assert vars(spec.config) == vars(ref.config)
    assert vars(spec.smoke_config) == vars(ref.smoke_config)
    assert {k: vars(v) for k, v in spec.shapes.items()} == \
        {k: vars(v) for k, v in ref.shapes.items()}
    assert (spec.family, spec.source, spec.notes) == \
        (ref.family, ref.source, ref.notes)
    assert "dimenet" in list_archs() and len(list_archs()) == 11


@pytest.mark.parametrize("d_feat", [0, FEAT])
def test_init_has_the_reference_leaves(d_feat):
    model = D.init_params(torch.Generator().manual_seed(0), CFG, d_feat)
    jp = jax.eval_shape(lambda: JD.init_params(jax.random.PRNGKey(0), CFG,
                                               d_feat))
    want = {param_name(k): np.shape(a) for k, a in _paths(jp)}
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # the reference's scales: bilinear normal x H^-0.5, zero biases
    std = float(model.blocks[0].bilinear.detach().std())
    assert 0.9 < std * CFG.d_hidden ** 0.5 < 1.1
    assert not any(b.detach().any() for b in model.msg_init.biases)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


# -- bases -----------------------------------------------------------------

def test_bases_match_the_reference():
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.uniform(0, 7, 200), [0.0, 1e-8, 5.0, 6.5]]
                       ).astype(np.float32)
    angle = rng.uniform(0, np.pi, d.shape[0]).astype(np.float32)
    td, ta = torch.from_numpy(d), torch.from_numpy(angle)
    x = np.clip(d / CFG.cutoff, 1e-6, 1.0)
    np.testing.assert_allclose(
        D.envelope(torch.from_numpy(x), CFG.envelope_p).numpy(),
        np.asarray(JD.envelope(jnp.asarray(x), CFG.envelope_p)), rtol=1e-6)
    np.testing.assert_allclose(D.radial_basis(td, CFG).numpy(),
                               np.asarray(JD.radial_basis(jnp.asarray(d),
                                                          CFG)),
                               rtol=1e-6, atol=1e-6)
    got = D.spherical_basis(td, ta, CFG).numpy()
    want = np.asarray(JD.spherical_basis(jnp.asarray(d), jnp.asarray(angle),
                                         CFG))
    assert got.shape == (d.shape[0], CFG.n_radial * CFG.n_spherical)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_integer_power_is_square_and_multiply():
    x = torch.tensor([0.3, 0.7, 1.1], dtype=torch.float32)
    for k in range(1, 9):
        want = jax.lax.integer_pow(jnp.asarray(x.numpy()), k)
        assert np.array_equal(D._ipow(x, k).numpy(), np.asarray(want)), k


# -- the scatters and gathers ---------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 16])
def test_segment_sum_matches_jax_with_padding_as_minus_one(width):
    rng = np.random.default_rng(width)
    t, s = 300, 40
    data = rng.standard_normal((t, width)).astype(np.float32)
    ids = rng.integers(0, s, t).astype(np.int32)
    ids[rng.random(t) < 0.3] = -1
    ids[:50] = 7                                  # one long run
    keep = (ids >= 0).astype(np.float32)
    # the reference's form: padded ids clamped to 0, their rows times 0
    want = jax.ops.segment_sum(jnp.asarray(data * keep[:, None]),
                               jnp.asarray(np.maximum(ids, 0)),
                               num_segments=s)
    td = torch.from_numpy(data).requires_grad_(True)
    got = segment_sum(td, torch.from_numpy(ids), s)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    # the clamped, masked form through the port gives the same bits
    clamped = segment_sum(torch.from_numpy(data * keep[:, None]),
                          torch.from_numpy(np.maximum(ids, 0)), s)
    assert torch.equal(got.detach(), clamped)
    # the gradient is the gather of the incoming gradient
    g_out = rng.standard_normal((s, width)).astype(np.float32)
    (grad,) = torch.autograd.grad(got, td, torch.from_numpy(g_out))
    jgrad = jax.grad(lambda x: jnp.vdot(jax.ops.segment_sum(
        x * keep[:, None], jnp.asarray(np.maximum(ids, 0)),
        num_segments=s), jnp.asarray(g_out)))(jnp.asarray(data))
    assert np.array_equal(grad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("width", [1, 3, 16])
def test_the_one_id_bag_is_a_gather_whose_gradient_is_the_scatter(width):
    rng = np.random.default_rng(10 + width)
    v, t = 30, 250
    table = rng.standard_normal((v, width)).astype(np.float32)
    ids = rng.integers(0, v, t).astype(np.int32)
    ids[rng.random(t) < 0.3] = -1
    keep = (ids >= 0).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_(True)
    got = embedding_bag(tt, torch.from_numpy(ids)[:, None])
    want = jnp.take(jnp.asarray(table), jnp.asarray(np.maximum(ids, 0)),
                    axis=0) * keep[:, None]
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    g_out = rng.standard_normal((t, width)).astype(np.float32)
    (grad,) = torch.autograd.grad(got, tt, torch.from_numpy(g_out))
    jgrad = jax.grad(lambda x: jnp.vdot(jnp.take(
        x, jnp.asarray(np.maximum(ids, 0)), axis=0) * keep[:, None],
        jnp.asarray(g_out)))(jnp.asarray(table))
    assert np.array_equal(grad.numpy(), np.asarray(jgrad))


def test_segment_sum_refuses_bad_operands():
    x = torch.zeros((4, 2))
    with pytest.raises(TypeError):
        segment_sum(x.double(), torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_sum(x, torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_sum(x, torch.zeros(4, dtype=torch.int32), 0)


# -- the model -------------------------------------------------------------

def test_carry_is_bit_for_bit(cases):
    c = cases["x-nodes"]
    want = named_from_jax(c["jp"], CPU)
    got = dict(c["model"].named_parameters())
    assert set(got) == set(want)
    for n, p in got.items():
        assert torch.equal(p.detach(), want[n]), n


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_the_reference(cases, name):
    c = cases[name]
    with torch.no_grad():
        graph_out, node_out = D.forward(c["model"], CFG, _tgraph(c))
    _close(graph_out, c["fwd"][0], err_msg="graph_out")
    _close(node_out, c["fwd"][1], err_msg="node_out")
    assert graph_out.shape == c["fwd"][0].shape


@pytest.mark.parametrize("name", list(VARIANTS))
def test_loss_matches_the_reference(cases, name):
    c = cases[name]
    with torch.no_grad():
        loss, met = D.loss_fn(c["model"], CFG, _tgraph(c))
    _close(loss, c["loss"])
    assert met["loss"] is loss
    assert ("y_graph" in c["g"]) == (name != "x-nodes" and
                                     name != "sampled")


def test_node_reduce_is_applied_before_the_final_mlp(cases):
    c = cases["z-graphs"]
    g = _tgraph(c)
    jgraph = {k: jnp.asarray(v) for k, v in c["g"].items()}
    with torch.no_grad():
        plain = D.forward(c["model"], CFG, g)
        ident = D.forward(c["model"], CFG, g, node_reduce=lambda x: x)
        doubled = D.forward(c["model"], CFG, g, node_reduce=lambda x: 2 * x)
    assert all(torch.equal(a, b) for a, b in zip(plain, ident))
    want = jax.jit(lambda p, gr: JD.forward(
        p, CFG, gr, node_reduce=lambda x: 2 * x))(c["jp"], jgraph)
    _close(doubled[1], want[1])
    assert not torch.equal(doubled[1], plain[1])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_gradients_match_value_and_grad(cases, name):
    c = cases[name]
    ps = dict(c["model"].named_parameters())
    loss, _ = D.loss_fn(c["model"], CFG, _tgraph(c))
    grads = torch.autograd.grad(loss, list(ps.values()))
    want = named_from_jax(c["grads"], CPU)
    assert set(ps) == set(want)
    for (n, _), g in zip(ps.items(), grads):
        _close(g, want[n], rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)


def _plain_segment_sum(data, ids, n, plan=None):
    keep = ids >= 0
    return torch.zeros((n, data.shape[1]), dtype=data.dtype).index_add(
        0, ids[keep].long(), data[keep])


def _plain_gather(table, ids, plan=None):
    return table[ids.clamp_min(0).long()] * (ids >= 0)[:, None]


@pytest.mark.parametrize("name", ["x-nodes", "sampled"])
def test_gradients_are_near_float64(cases, name, monkeypatch):
    """The port's float32 gradients within GRAD_ATOL of each leaf's scale
    of the same model run in float64 (through plain float64 scatters), as
    close as the reference's own."""
    c = cases[name]
    ps = dict(c["model"].named_parameters())
    loss, _ = D.loss_fn(c["model"], CFG, _tgraph(c))
    grads = dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))
    wide = gnn_params_from_jax(c["jp"], CFG, CPU).double()
    monkeypatch.setattr(D, "segment_sum", _plain_segment_sum)
    monkeypatch.setattr(D, "_gather", _plain_gather)
    g64 = {k: v.double() if v.is_floating_point() else v
           for k, v in _tgraph(c).items()}
    ps64 = dict(wide.named_parameters())
    loss64, _ = D.loss_fn(wide, CFG, g64)
    exact = dict(zip(ps64, torch.autograd.grad(loss64,
                                               list(ps64.values()))))
    _close(loss.detach(), loss64.detach().float())
    for n, g in grads.items():
        _close(g, exact[n].float(), rtol=GRAD_RTOL, atol=GRAD_ATOL,
               err_msg=n)


def test_one_adamw_step_on_the_reference_gradients(cases):
    c = cases["x-nodes"]
    jopt, opt = jax_adamw(1e-3), adamw(1e-3)
    jnew, jstate, jmet = jax.jit(jopt.update)(c["grads"], jopt.init(c["jp"]),
                                              c["jp"])
    model = gnn_params_from_jax(c["jp"], CFG, CPU)
    _, state, met = opt.update(named_from_jax(c["grads"], CPU),
                               opt.init(model), model)
    _close(met["grad_norm"], jmet["grad_norm"], rtol=STEP_RTOL,
           atol=STEP_ATOL)
    want = named_from_jax(jnew, CPU)
    for n, p in model.named_parameters():
        _close(p.detach(), want[n], rtol=STEP_RTOL, atol=STEP_ATOL,
               err_msg=n)
    for key in ("m", "v"):
        for n, t in named_from_jax(jstate[key], CPU).items():
            _close(state[key][n], t, rtol=STEP_RTOL, atol=STEP_ATOL,
                   err_msg=f"{key} {n}")


class _AtomicAdds(TorchDispatchMode):
    """Records the accumulating scatters that run outside the bag kernels'
    plain versions (which add rank by rank over distinct ids)."""

    ADDS = ("index_add", "scatter_add", "scatter_reduce", "index_put")

    def __init__(self):
        super().__init__()
        self.inside, self.seen = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        accumulate = "index_put" not in name or bool(
            (kwargs or {}).get("accumulate", args[3] if len(args) > 3
                               else False))
        if not self.inside and accumulate and any(a in name
                                                  for a in self.ADDS):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_the_step_adds_with_no_atomic_scatter(cases, monkeypatch):
    c = cases["sampled"]
    mode = _AtomicAdds()

    def counted(fn):
        def inner(*a, **k):
            mode.inside += 1
            try:
                return fn(*a, **k)
            finally:
                mode.inside -= 1
        return inner

    for name in ("embedding_bag_ref", "embedding_bag_backward_ref"):
        monkeypatch.setattr(bag_ops, name, counted(getattr(bag_ops, name)))
    ps = list(c["model"].parameters())
    with mode:
        loss, _ = D.loss_fn(c["model"], CFG, _tgraph(c))
        torch.autograd.grad(loss, ps)
    assert mode.seen == []
    # the probe does see autograd's scatter of an indexed parameter
    with mode:
        torch.autograd.grad(c["model"].embed[torch.tensor([0, 0])].sum(),
                            c["model"].embed)
    assert mode.seen


def test_train_step_through_loss_fn_for(cases):
    c = cases["z-graphs"]
    model = gnn_params_from_jax(c["jp"], CFG, CPU)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw(1e-3)
    step = make_train_step(loss_fn_for("gnn", CFG), opt)
    state = opt.init(model)
    losses = []
    for _ in range(2):
        model, state, met = step(model, state, _tgraph(c))
        losses.append(float(met["loss"]))
    _close(losses[0], c["loss"])
    assert all(np.isfinite(losses))
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters())
    assert int(state["step"]) == 2


# -- chip_smoke.py's card checks, their host side --------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["z-graphs", "x-nodes"])
def test_float64_yardstick_takes_the_runs_bases_and_branches(name):
    """gnn_loss_and_grads records a run's bases and ReLU masks without
    changing a bit; gnn_float64_grads on them is within GRAD_ATOL of the
    run, follows a changed mask, and refuses a mask list of another
    length."""
    smoke = _chip_smoke()
    kw = dict(VARIANTS[name])
    seed = kw.pop("seed")
    graph = graph_to_device(PG.make_dimenet_batch(seed, **kw), CPU)
    cfg = get_arch("dimenet").smoke_config
    model = D.init_params(torch.Generator().manual_seed(seed), cfg,
                          kw.get("d_feat", 0))
    kept = torch.relu, D.radial_basis, D.spherical_basis
    taken = {}
    got = smoke.gnn_loss_and_grads(torch, model, cfg, graph, taken)
    assert (torch.relu, D.radial_basis, D.spherical_basis) == kept
    plain = smoke.gnn_loss_and_grads(torch, model, cfg, graph)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert sorted(taken) == ["rbf", "relu", "sbf"] and taken["relu"]
    wide = smoke.gnn_float64_grads(torch, model, cfg, graph, taken)
    assert (torch.relu, D.segment_sum, D._gather) == (kept[0], segment_sum,
                                                      D._gather)
    for a, w in zip(got, wide):
        assert w.dtype == torch.float64
        _close(a, w, rtol=0, atol=GRAD_ATOL)
    shut = dict(taken, relu=[torch.zeros_like(taken["relu"][0])]
                + taken["relu"][1:])
    moved = smoke.gnn_float64_grads(torch, model, cfg, graph, shut)
    assert not all(torch.equal(a, b) for a, b in zip(moved, wide))
    for masks in (taken["relu"] + taken["relu"][:1], taken["relu"][:-1]):
        with pytest.raises(AssertionError, match="ReLU calls"):
            smoke.gnn_float64_grads(torch, model, cfg, graph,
                                    dict(taken, relu=masks))


def test_kernel_cases_pass_padding_as_minus_one():
    """gnn_kernel_cases: each case's ids are the batch's, -1 exactly where
    the edge, triplet or node is padding, at the width its call has."""
    smoke = _chip_smoke()
    cfg = get_arch("dimenet").config
    big = PG.make_dimenet_batch(4, 40, 96, 200, d_feat=FEAT,
                                node_targets=True)
    mol = PG.make_dimenet_batch(0, 48, 96, 256, n_graphs=4)
    mol["node_mask"][-5:] = False
    cases = {c[0]: c[1:] for c in smoke.gnn_kernel_cases(
        cfg, {"minibatch_lg": big, "molecule": mol})}
    t_ok = (big["t_kj"] >= 0) & (big["t_ji"] >= 0)
    want = {
        "agg": ("embedding_bag_backward", np.where(t_ok, big["t_ji"], -1),
                96, cfg.d_hidden),
        "node_readout": ("embedding_bag_backward",
                         np.where(big["edge_mask"], big["dst"], -1), 40,
                         cfg.d_hidden),
        "gather_w_kj": ("embedding_bag", np.where(t_ok, big["t_kj"], -1),
                        96, cfg.d_hidden),
        "graph_readout": ("embedding_bag_backward",
                          np.where(mol["node_mask"], mol["graph_id"], -1),
                          4, 1),
        "gather_graph_readout": ("embedding_bag",
                                 np.where(mol["node_mask"], mol["graph_id"],
                                          -1), 4, 1)}
    assert list(cases) == list(want)
    for key, (kernel, ids, rows, d) in want.items():
        got_kernel, got_ids, got_rows, got_d = cases[key][1:]
        assert (cases[key][0], got_kernel, got_rows, got_d) == (
            "molecule" if "graph" in key else "minibatch_lg", kernel, rows,
            d)
        np.testing.assert_array_equal(got_ids, ids)
    assert (cases["agg"][2] == -1).any()
    assert (cases["graph_readout"][2] == -1).sum() == 5
