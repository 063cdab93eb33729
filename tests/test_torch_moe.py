"""The port's MoE layer (``models/moe.py``) and the MoE LM
(deepseek-moe-16b's smoke config) against the reference's, on the CPU.

The router: ids exact, weights and the aux loss to rtol 1e-6, ties to the
lower expert. The layer, on carried perturbed weights, in two variants:
the smoke config (capacity factor 8: nothing drops) and one whose groups
of 8 tokens and capacity factor 0.5 give 3 groups of capacity 2, where
tokens drop; the drop set must be the reference's exactly, and each
input's smallest probability margin among the top k + 1 is asserted, so
that an id flip from rounding cannot pass for a fault. The model: forward,
``lm_loss`` (aux included), gradients against ``jax.value_and_grad``, one
AdamW step, prefill then decode, a bf16 variant, the launchers; at the
tolerances of ``tests/test_torch_transformer.py`` (float32 to rtol 1e-5 /
atol 1e-6 of the compared tensor's scale, gradients atol 3e-6 of each
leaf's; bf16 atol 0.03 of the scale).
"""
import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import flags as jax_flags
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import reduced_lm as jax_reduced_lm
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro_torch import flags
from repro_torch.carry import lm_named_from_jax, lm_params_from_jax
from repro_torch.configs import get_arch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 3e-6
BF16_TOL = dict(rtol=0.0, atol=0.03)
CPU = torch.device("cpu")
ARCH = "deepseek-moe-16b"


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
        dt = a.dtype
        a = np.asarray(a, np.float32)
        spread = float(a.std()) or 1.0
        moved = a + (rng.standard_normal(a.shape) * 0.1 * spread).astype(
            np.float32)
        return jnp.asarray(moved).astype(dt)
    return jax.tree.map(move, tree)


SMOKE = jax_get_arch(ARCH).smoke_config
VARIANTS = {
    ARCH: SMOKE,
    # 2 x 12 tokens in 3 groups of 8, capacity max(2, int(8*2*0.5/8)+1) = 2
    ARCH + "-drops": jax_reduced_lm(jax_get_arch(ARCH).config,
                                    moe_group_size=8,
                                    moe_capacity_factor=0.5),
    ARCH + "-bf16": replace(SMOKE, dtype="bfloat16"),
}
F32 = [v for v in VARIANTS if not v.endswith("bf16")]


@pytest.fixture(scope="module")
def models():
    """Per variant: the reference's perturbed params, the port's model
    over them, and a numpy batch (B = 2, S = 12)."""
    out = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        jp = _perturbed(JT.init_params(jax.random.PRNGKey(0), cfg), 30 + i)
        rng = np.random.default_rng(40 + i)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        out[name] = dict(cfg=cfg, jp=jp,
                         model=lm_params_from_jax(jp, cfg, CPU),
                         tokens=tokens, labels=np.roll(tokens, -1, 1))
    return out


# the reference's serving entry points, compiled once per config
_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def _batch(m, torch_side):
    if torch_side:
        return {"tokens": torch.from_numpy(m["tokens"]),
                "labels": torch.from_numpy(m["labels"])}
    return {"tokens": jnp.asarray(m["tokens"]),
            "labels": jnp.asarray(m["labels"])}


def _layer(m):
    """The first MoE layer: the reference's stacked slice 0, the port's
    block 1 (behind the one dense block)."""
    jmoe = jax.tree.map(lambda a: a[0], m["jp"]["layers"]["moe"])
    return jmoe, m["model"].blocks[1].moe


def _min_margin(probs, k):
    """The smallest gap between neighbours among each row's top k + 1
    probabilities."""
    top = -np.sort(-np.asarray(probs), axis=-1)[:, :k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def _ref_in_cap(idx, g, e, cap):
    """The reference's keep mask (moe.py:84-89) from its own ids."""
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(g, -1, idx.shape[-1]),
                            e, dtype=jnp.int32)
    flat = onehot.reshape(g, -1, e)
    pos = (jnp.cumsum(flat, axis=1) - 1).reshape(onehot.shape)
    mine = jnp.sum(pos * onehot, axis=-1)        # the pair's own position
    return np.asarray(mine < cap).reshape(idx.shape)


# -- the router --------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k", [(24, 8, 2), (64, 64, 6), (37, 160, 6)])
def test_route_matches_the_reference(t, e, k):
    logits = np.random.default_rng(t + e).standard_normal(
        (t, e)).astype(np.float32) * 3
    w, idx, aux = M._route(torch.from_numpy(logits), k)
    jw, jidx, jaux = JM._route(jnp.asarray(logits), k)
    assert idx.shape == (t, k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert _min_margin(jax.nn.softmax(jnp.asarray(logits)), k) > 1e-6


def test_route_ties_go_to_the_lower_expert(models):
    """A zero router gives every token uniform probabilities: both pick
    experts 0 .. k-1, with weights 1/k; the layer still equals the
    reference's."""
    cfg = SMOKE
    logits = np.zeros((10, cfg.n_routed_experts), np.float32)
    logits[3, 5] = logits[3, 6] = 1.0                # one tie above the rest
    w, idx, aux = M._route(torch.from_numpy(logits), cfg.moe_top_k)
    jw, jidx, jaux = JM._route(jnp.asarray(logits), cfg.moe_top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1] and idx[3].tolist() == [5, 6]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    jmoe, moe = _layer(models[ARCH])
    jmoe = dict(jmoe, router=jnp.zeros_like(jmoe["router"]))
    zero = M.MoE(torch.zeros_like(moe.router), moe.w_gate.detach(),
                 moe.w_up.detach(), moe.w_down.detach(), moe.shared)
    x = np.random.default_rng(5).standard_normal((2, 12, cfg.d_model))
    x = x.astype(np.float32)
    with torch.no_grad():
        out, aux = M.moe_apply(zero, cfg, torch.from_numpy(x))
    jout, jaux = JM.moe_apply(jmoe, cfg, jnp.asarray(x))
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# -- the layer ---------------------------------------------------------------------

@pytest.mark.parametrize("name", F32)
def test_moe_apply_matches_the_reference(models, name):
    m = models[name]
    cfg = m["cfg"]
    jmoe, moe = _layer(m)
    x = np.random.default_rng(7).standard_normal((2, 12, cfg.d_model))
    x = x.astype(np.float32)
    out, aux = M.moe_apply(moe, cfg, torch.from_numpy(x))
    jout, jaux = JM.moe_apply(jmoe, cfg, jnp.asarray(x))
    assert out.shape == (2, 12, cfg.d_model) and out.dtype == torch.float32
    _close(out.detach(), jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # the ids and the drop set
    k, e = cfg.moe_top_k, cfg.n_routed_experts
    logits = x.reshape(24, -1) @ np.asarray(jmoe["router"])
    probs = jax.nn.softmax(jnp.asarray(logits))
    assert _min_margin(probs, k) > 1e-5          # seed 7's: no near-tie
    _, jidx, _ = JM._route(jnp.asarray(logits), k)
    _, idx, _ = M._route(torch.from_numpy(logits), k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    g, gs, cap = M.groups_and_capacity(cfg, 24)
    slot = M.dispatch_slots(idx, g, e, cap)
    kept = (slot < e * g * cap).numpy()
    assert np.array_equal(kept, _ref_in_cap(np.asarray(jidx), g, e, cap))
    if name.endswith("drops"):
        assert (g, gs, cap) == (3, 8, 2)
        assert 0 < int((~kept).sum()) < kept.size
    else:
        assert kept.all()
    # every kept pair has its own slot
    used = slot[torch.from_numpy(kept)]
    assert used.unique().numel() == used.numel()


@pytest.mark.parametrize("name", F32)
def test_moe_apply_gradients_match_the_reference(models, name):
    """d(sum(out * r) + aux)/d(x, router, experts) against jax.grad: the
    router's gradient comes through the combine weights and the aux."""
    m = models[name]
    cfg = m["cfg"]
    jmoe, moe = _layer(m)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, aux = JM.moe_apply(p, cfg, xx)
        return jnp.sum(out * r) + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jmoe, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = M.moe_apply(moe, cfg, xt)
    loss = (out * torch.from_numpy(r)).sum() + aux
    names = ["router", "w_gate", "w_up", "w_down"]
    tensors = [moe[n] for n in names] + list(moe.shared.values())
    grads = torch.autograd.grad(loss, tensors + [xt])
    want = [jg[n] for n in names] + [jg["shared"][n]
                                     for n in moe.shared.keys()]
    for n, got, w in zip(names + list(moe.shared.keys()), grads, want):
        _close(got, w, atol=GRAD_ATOL, err_msg=n)
    _close(grads[-1], jgx, atol=GRAD_ATOL, err_msg="x")
    assert float(np.abs(np.asarray(jg["router"])).max()) > 0


def test_moe_apply_bf16_matches_the_reference(models):
    m = models[ARCH + "-bf16"]
    cfg = m["cfg"]
    jmoe, moe = _layer(m)
    x = np.random.default_rng(9).standard_normal((2, 12, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    out, aux = M.moe_apply(moe, cfg, tx)
    jout, jaux = JM.moe_apply(jmoe, cfg, jx)
    assert out.dtype == torch.bfloat16
    _close(out.detach().float(), np.asarray(jout.astype(jnp.float32)),
           **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_indivisible_groups_raise():
    """21 tokens in groups of 8: 2 groups of 10 leave one over."""
    cfg = VARIANTS[ARCH + "-drops"]
    x = np.zeros((3, 7, cfg.d_model), np.float32)
    jmoe = JM.moe_init(jax.random.PRNGKey(0), cfg)
    with pytest.raises(AssertionError, match="not divisible"):
        JM.moe_apply(jmoe, cfg, jnp.asarray(x))
    moe = M.moe_init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="not divisible by groups 2"):
        M.moe_apply(moe, cfg, torch.from_numpy(x))
    assert M.groups_and_capacity(cfg, 24) == (3, 8, 2)
    assert M.groups_and_capacity(SMOKE, 24) == (1, 24, 49)


def test_routing_log_records_counts_and_drops(models):
    m = models[ARCH + "-drops"]
    cfg = m["cfg"]
    _, moe = _layer(m)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    with M.routing_log() as log:
        M.moe_apply(moe, cfg, x)
    M.moe_apply(moe, cfg, x)                       # closed: not recorded
    assert len(log) == 1
    rec = log[0]
    assert int(rec["counts"].sum()) == rec["pairs"] == 48
    assert rec["slots"] == 8 * 3 * 2 and 0 < int(rec["kept"]) < 48


def test_forced_routing_takes_the_given_ids(models):
    """Its own ids give the same numbers; other ids are routed to, with
    the router's probabilities there renormalized; a call past the given
    routings raises."""
    m = models[ARCH + "-drops"]
    cfg = m["cfg"]
    _, moe = _layer(m)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32))
    with M.routing_log() as log:
        want, want_aux = M.moe_apply(moe, cfg, x)
    own = log[0]["ids"]
    with M.forced_routing([own]):
        got, aux = M.moe_apply(moe, cfg, x)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)

    logits = (x.reshape(-1, cfg.d_model) @ moe.router).detach()
    probs = torch.softmax(logits, -1)
    last = torch.sort(probs, dim=-1, stable=True).indices[
        :, :cfg.moe_top_k]                               # the bottom k
    with M.forced_routing([last]), M.routing_log() as log:
        M.moe_apply(moe, cfg, x)
        with pytest.raises(RuntimeError, match="more moe_apply calls"):
            M.moe_apply(moe, cfg, x)
    assert torch.equal(log[0]["ids"], last)
    w, idx, _ = M._route(logits, cfg.moe_top_k, last)
    p = probs.gather(1, last)
    torch.testing.assert_close(w, p / p.sum(-1, keepdim=True), rtol=0,
                               atol=0)
    assert torch.equal(idx, last)


@pytest.mark.parametrize("name", [ARCH, ARCH + "-bf16"])
def test_init_has_the_reference_leaves_and_dtypes(name):
    """moe_init's leaves, shapes and types are the reference's: the
    router float32 in a bf16 config too."""
    cfg = VARIANTS[name]
    jmoe = JM.moe_init(jax.random.PRNGKey(0), cfg)
    want = {".".join(p.key for p in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(jmoe)}
    moe = M.moe_init(torch.Generator().manual_seed(0), cfg)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in moe.named_parameters()}
    assert got == want
    assert moe.router.dtype == torch.float32


# -- the model ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_and_carry_have_the_reference_leaves(models, name):
    m = models[name]
    cfg, jp = m["cfg"], m["jp"]
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in lm_named_from_jax(jp, CPU).items()}
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    got = {k: (tuple(v.shape), v.dtype) for k, v in mine.named_parameters()}
    assert got == want
    assert "blocks.0.ffn.w_up" in got and "blocks.1.moe.shared.w_up" in got
    assert got["blocks.0.ffn.w_up"][0] == (cfg.d_model, cfg.dense_d_ff)
    carried = dict(m["model"].named_parameters())
    leaf = np.asarray(jp["layers"]["moe"]["w_down"][0])
    assert np.array_equal(
        carried["blocks.1.moe.w_down"].detach().float().numpy(),
        leaf.astype(np.float32))
    leaf = np.asarray(jp["dense_layers"][0]["ffn"]["w_gate"])
    assert np.array_equal(
        carried["blocks.0.ffn.w_gate"].detach().float().numpy(),
        leaf.astype(np.float32))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_logits_and_aux(models, name):
    m = models[name]
    got, aux = T.forward(m["model"], m["cfg"], torch.from_numpy(m["tokens"]))
    want, jaux = JT.forward(m["jp"], m["cfg"], jnp.asarray(m["tokens"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(jaux) > 0
    if name.endswith("bf16"):
        _close(got.detach(), want, **BF16_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)
    else:
        _close(got.detach(), want)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("sharded_ce", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_lm_loss_includes_the_aux(models, name, sharded_ce, monkeypatch):
    monkeypatch.setattr(flags, "SHARDED_CE", sharded_ce)
    monkeypatch.setattr(jax_flags, "SHARDED_CE", sharded_ce)
    m = models[name]
    total, met = T.lm_loss(m["model"], m["cfg"], _batch(m, True))
    jtotal, jmet = JT.lm_loss(m["jp"], m["cfg"], _batch(m, False))
    if name.endswith("bf16"):
        # bf16: the loss to rtol 1e-3 (ppl = exp(loss) on each side)
        _close(total.detach(), jtotal, rtol=1e-3, atol=0.0)
        for key in ("loss", "aux"):
            _close(met[key].detach(), jmet[key], rtol=1e-3, atol=0.0)
        _close(met["ppl"].detach(), np.exp(np.float32(met["loss"].item())))
    else:
        _close(total.detach(), jtotal)
        for key in ("loss", "aux", "ppl"):
            _close(met[key].detach(), jmet[key])
    assert float(total - met["loss"]) == pytest.approx(
        m["cfg"].router_aux_loss * float(met["aux"]), rel=1e-3)


@pytest.fixture(scope="module")
def ref_grads(models):
    out = {}
    for name in F32:
        m = models[name]
        (_, _), g = jax.jit(jax.value_and_grad(
            lambda p: JT.lm_loss(p, m["cfg"], _batch(m, False)),
            has_aux=True))(m["jp"])
        out[name] = (g, lm_named_from_jax(g, CPU))
    return out


@pytest.mark.parametrize("name", F32)
def test_gradients_match_value_and_grad(models, ref_grads, name):
    model = models[name]["model"]
    ps = dict(model.named_parameters())
    loss, _ = T.lm_loss(model, models[name]["cfg"], _batch(models[name],
                                                          True))
    grads = torch.autograd.grad(loss, list(ps.values()))
    want = ref_grads[name][1]
    assert set(ps) == set(want)
    for (n, _), g in zip(ps.items(), grads):
        _close(g, want[n], atol=GRAD_ATOL, err_msg=n)


def test_one_adamw_step_on_the_reference_gradients(models, ref_grads):
    m = models[ARCH]
    jopt, opt = jax_adamw(3e-4), adamw(3e-4)
    jg, named = ref_grads[ARCH]
    jnew, jstate, jmet = jax.jit(jopt.update)(jg, jopt.init(m["jp"]),
                                              m["jp"])
    model = lm_params_from_jax(m["jp"], m["cfg"], CPU)
    _, state, met = opt.update({k: v.clone() for k, v in named.items()},
                               opt.init(model), model)
    _close(met["grad_norm"], jmet["grad_norm"])
    want = lm_named_from_jax(jnew, CPU)
    for n, p in model.named_parameters():
        _close(p.detach(), want[n], err_msg=n)
    for key in ("m", "v"):
        for n, t in lm_named_from_jax(jstate[key], CPU).items():
            _close(state[key][n], t, err_msg=f"{key} {n}")


def test_remat_changes_no_number(models):
    m = models[ARCH + "-drops"]
    ps = list(m["model"].parameters())
    out = []
    for remat in (True, False):
        loss, _ = T.lm_loss(m["model"], m["cfg"], _batch(m, True),
                            remat=remat)
        out.append([loss] + list(torch.autograd.grad(loss, ps)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("name", [ARCH, ARCH + "-bf16"])
def test_prefill_then_decode_matches_forward(models, name):
    """Prefill 8 tokens into a 12-slot cache, decode 4 of the reference's
    greedy ids: each step's logits equal the reference's decode and the
    port's forward over the 12 tokens (nothing drops at these sizes, so
    the decode's groups of 2 route as forward's group of 24); the caches
    equal the reference's."""
    m = models[name]
    cfg = m["cfg"]
    tol = BF16_TOL if name.endswith("bf16") else {}
    prompt = m["tokens"][:, :8]
    logits, cache = T.prefill(m["model"], cfg, torch.from_numpy(prompt),
                              max_len=12)
    jl, jc = _jprefill(m["jp"], cfg, jnp.asarray(prompt), 12)
    _close(logits, np.asarray(jl), **tol)
    want = np.asarray(jl[:, -1])
    seq, steps = [prompt], []
    for i in range(4):
        tok = want.argmax(-1).astype(np.int32)
        seq.append(tok[:, None])
        pos = np.full((2,), 8 + i, np.int32)
        got, cache = T.decode_step(m["model"], cfg, torch.from_numpy(tok),
                                   cache, torch.from_numpy(pos))
        jlg, jc = _jdecode(m["jp"], cfg, jnp.asarray(tok), jc,
                           jnp.asarray(pos))
        want = np.asarray(jlg)
        _close(got, want, **tol)
        steps.append(got)
    full = np.concatenate(seq, axis=1)
    with torch.no_grad():
        fwd, _ = T.forward(m["model"], cfg, torch.from_numpy(full))
    for i, lg in enumerate(steps):
        _close(lg, fwd[:, 8 + i], **tol)
    _close(cache.a.float(), np.asarray(jc.a.astype(jnp.float32)), **tol)
    _close(cache.b.float(), np.asarray(jc.b.astype(jnp.float32)), **tol)
    assert np.array_equal(cache.length.numpy(), np.asarray(jc.length))


def test_decode_rows_share_capacity_as_the_reference(models):
    """At decode the B rows form one group; with capacity factor 0.5 and
    2 rows, cap = max(k, 1) = 2 >= B, so each expert holds every row; the
    decode equals the reference's on the drops variant's weights."""
    m = models[ARCH + "-drops"]
    cfg = m["cfg"]
    assert M.groups_and_capacity(cfg, 2) == (1, 2, 2)
    logits, cache = T.prefill(m["model"], cfg,
                              torch.from_numpy(m["tokens"][:, :8]),
                              max_len=12)
    jl, jc = _jprefill(m["jp"], cfg, jnp.asarray(m["tokens"][:, :8]), 12)
    _close(logits, np.asarray(jl))
    tok = np.asarray(jl[:, -1]).argmax(-1).astype(np.int32)
    pos = np.full((2,), 8, np.int32)
    got, _ = T.decode_step(m["model"], cfg, torch.from_numpy(tok), cache,
                           torch.from_numpy(pos))
    want, _ = _jdecode(m["jp"], cfg, jnp.asarray(tok), jc, jnp.asarray(pos))
    _close(got, want)


# -- the launchers -------------------------------------------------------------------

def test_serve_launcher_prints_the_reference_line(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--tokens", "4"])
    out = capsys.readouterr().out
    assert re.fullmatch(re.escape(ARCH) + r": prefill\(32\) \+ decode\(4\) "
                        r"for batch 2 in \d+\.\d\ds \(\d+\.\d tok/s\)\n",
                        out), out


def test_train_launcher_trains_the_moe_lm(tmp_path, capsys):
    train_main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq",
                "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"deepseek-moe-16b: trained 2 steps; "
                        r"history=\[\d+\.\d+, \d+\.\d+\]", line), line
    spec, ref = get_arch(ARCH), jax_get_arch(ARCH)
    assert vars(spec.config) == vars(ref.config)
    assert vars(spec.smoke_config) == vars(ref.smoke_config)
