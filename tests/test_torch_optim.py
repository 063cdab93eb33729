"""The port's optimizers (``optim/adamw.py``, ``optim/compression.py``)
against the reference's, on the reference's own gradients: the two-tower
smoke model's (a table, the towers' weights and biases), carried by name.

Both packages write the same float32 arithmetic, but XLA on the CPU
contracts a multiply and an add into one fused multiply-add where PyTorch
rounds twice, and sums a leaf's squares in another order, so values are
held to rtol 1e-6. An update p - delta (or a moment b * m + (1 - b) * g)
whose two terms nearly cancel keeps the ulps of its operands, not of its
result, so each parameter and state leaf also takes an atol of 1e-6 times
its largest element. Each optimizer takes one step from a fresh state,
and a third step from the reference's state after two (params and state
carried with ``repro_torch.carry``).
The int8 compression sees the same bits and rounds the same way: its
output is held to the same rtol for three rounds of error feedback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jax_recsys
from repro.optim import adamw as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import compress_with_feedback as jax_compress
from repro.optim import compression_ratio as jax_compression_ratio
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import global_norm as jax_global_norm
from repro.optim import init_error_state as jax_init_error_state
from repro.optim import mixed_optimizer as jax_mixed
from repro_torch.carry import named_from_jax, optimizer_state_from_jax
from repro_torch.optim import adamw, clip_by_global_norm, \
    compress_with_feedback, compression_ratio, cosine_schedule, \
    global_norm, init_error_state, mixed_optimizer
from repro_torch.optim.adamw import _adagrad_rows_

RTOL, ATOL = 1e-6, 1e-9
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, **kw)


def _close_leaf(got, want, **kw):
    """rtol 1e-6, atol 1e-6 of the leaf's scale (see the docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()), **kw)


def _named(tree, grad=False):
    out = named_from_jax(tree, CPU)
    return {n: t.requires_grad_() for n, t in out.items()} if grad else out


@pytest.fixture(scope="module")
def ref():
    """The two-tower smoke params (seed 0) and three gradient trees of its
    loss on three numpy batches (the reference's own gradients)."""
    cfg = jax_get_arch("two-tower-retrieval").smoke_config
    params = jax_recsys.INIT["two-tower-retrieval"](jax.random.PRNGKey(0),
                                                    cfg)
    grad = jax.jit(jax.grad(lambda p, b: jax_recsys.LOSS[
        "two-tower-retrieval"](p, cfg, b)[0]))
    grads = []
    for s in range(3):
        rng = np.random.default_rng(s)
        batch = {"sparse_ids": [jnp.asarray(rng.integers(
            0, v, (16, h)).astype(np.int32)) for v, h in
            zip(cfg.table_vocabs, cfg.multi_hot)]}
        grads.append(grad(params, batch))
    return params, grads


def test_global_norm_and_clip(ref):
    _, grads = ref
    _close(global_norm(_named(grads[0])).item(),
           float(jax_global_norm(grads[0])))
    for max_norm in (0.05, 1e3):                 # scaled, and left alone
        want, wn = jax_clip(grads[0], max_norm)
        got = _named(grads[0])
        out, n = clip_by_global_norm(got, max_norm)
        assert out is got                        # scaled in place
        _close(n.item(), float(wn))
        for name, g in _named(want).items():
            _close(got[name], g, err_msg=name)


@pytest.mark.parametrize("args", [(1e-3, 10, 100, 0.1), (3e-4, 0, 50, 0.0),
                                  (1.0, 7, 7, 0.5)])
def test_cosine_schedule(args):
    got, want = cosine_schedule(*args), jax_cosine(*args)
    for step in range(0, args[2] + 3):
        _close(got(torch.tensor(float(step))).item(),
               float(want(jnp.float32(step))), err_msg=str(step))


def _steps(jopt, opt, ref, carried):
    """One step from a fresh state, or (carried) step 3 from the
    reference's state after two; returns (port params, port state,
    reference params, reference state)."""
    params, grads = ref
    jp, js = params, jopt.init(params)
    if carried:
        for g in grads[:2]:
            jp, js, _ = jopt.update(g, js, jp)
    g = grads[2 if carried else 0]
    pp = _named(jp, grad=True)
    ps = optimizer_state_from_jax(js, CPU) if carried else opt.init(pp)
    jp, js, jinfo = jopt.update(g, js, jp)
    pp, ps, info = opt.update(_named(g), ps, pp)
    _close(info["grad_norm"].item(), float(jinfo["grad_norm"]))
    _close(info["lr"].item(), float(jinfo["lr"]))
    return pp, ps, jp, js


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.01, "clip_norm": None},
                                {"clip_norm": 0.05, "b2": 0.999}])
def test_adamw(ref, kw, carried):
    pp, ps, jp, js = _steps(jax_adamw(1e-3, **kw), adamw(1e-3, **kw), ref,
                            carried)
    for name, want in _named(jp).items():
        _close_leaf(pp[name].detach(), want, err_msg=name)
    for key in ("m", "v"):
        for name, want in _named(js[key]).items():
            _close_leaf(ps[key][name], want, err_msg=f"{key} {name}")
    assert int(ps["step"]) == int(js["step"])


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_mixed_optimizer(ref, lr, carried):
    """Row-wise Adagrad on the table, AdamW on the towers."""
    sched = {"const": (1e-3, 1e-3),
             "cosine": (cosine_schedule(1e-3, 2, 10),
                        jax_cosine(1e-3, 2, 10))}[lr]
    pp, ps, jp, js = _steps(jax_mixed(sched[1], table_lr=0.05),
                            mixed_optimizer(sched[0], table_lr=0.05), ref,
                            carried)
    for name, want in _named(jp).items():
        _close_leaf(pp[name].detach(), want, err_msg=name)
    want_state = named_from_jax(js["leaves"], CPU)
    assert set(ps["leaves"]) == {n.rsplit(".", 1)[0] for n in want_state}
    assert set(ps["leaves"]["table"]) == {"acc"}
    for name, s in ps["leaves"].items():
        for key, t in s.items():
            _close_leaf(t, want_state[f"{name}.{key}"],
                        err_msg=f"{name} {key}")


def test_table_update_in_row_chunks_is_the_whole_table_update():
    """The table's chunked update gives every element the value of the
    update over the whole table, bit for bit."""
    g = torch.Generator().manual_seed(3)
    p = torch.randn((1000, 24), generator=g)
    grad = torch.randn((1000, 24), generator=g)
    acc = torch.rand((1000,), generator=g)
    whole = (p.clone(), acc.clone())
    _adagrad_rows_(whole[0], grad, whole[1], 0.05, 1e-8, rows=1 << 20)
    for rows in (1, 7, 333):
        part = (p.clone(), acc.clone())
        _adagrad_rows_(part[0], grad, part[1], 0.05, 1e-8, rows=rows)
        assert torch.equal(part[0], whole[0])
        assert torch.equal(part[1], whole[1])


def test_compress_with_feedback(ref):
    params, grads = ref
    je, pe = jax_init_error_state(params), init_error_state(_named(params))
    for g in grads:
        jg, je = jax_compress(g, je)
        pg, pe = compress_with_feedback(_named(g), pe)
        for name, want in _named(jg).items():
            _close(pg[name], want, err_msg=name)
        for name, want in _named(je).items():
            _close(pe[name], want, err_msg=name)
    assert compression_ratio(_named(params)) == pytest.approx(
        jax_compression_ratio(params), rel=1e-12)
