"""The port's multi-head latent attention (``models/layers.py``'s ``mla_*``)
and the MLA + MoE LM (deepseek-v2-236b's smoke config) against the
reference's, on the CPU.

Each ``mla_*`` function on carried perturbed weights (the smoke config's
q LoRA, and a variant with a plain ``wq``); ``mla_apply`` above
CHUNK_THRESHOLD through the padded ``chunked_sdpa``; the absorbed decode
against the rebuilding one and both against the reference, a write past
the cache dropped; then the model: forward, ``lm_loss``, gradients
against ``jax.value_and_grad``, one AdamW step, prefill then decode, the
cache layout, the carried leaves, the serve steps' decode past a prompt
cache (the reference's ``tests/test_smoke_archs.py`` contract) and the
launchers. Float32 results to rtol 1e-5 / atol 1e-6 of the compared
tensor's scale, gradients atol 3e-6 of each leaf's, as
``tests/test_torch_transformer.py``; two measured exceptions are stated at
their constants (``ROUTER_GRAD_ATOL``, ``LONG_ATOL``).
"""
import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro.serve.serve_step import lm_decode_step as jax_decode_step
from repro.serve.serve_step import lm_prefill_step as jax_prefill_step
from repro_torch.carry import lm_named_from_jax, lm_params_from_jax
from repro_torch.configs import get_arch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 3e-6
# the router's gradient goes through the softmax's backward, which XLA and
# torch form differently, then sums over the tokens with cancellation:
# 3.2e-6 of the leaf's scale measured (seed 50) against the 2.7e-6 of
# the dense LM's worst leaf
ROUTER_GRAD_ATOL = 1e-5
# S = 2048 through two layers: each layer's output within 4.7e-7 of its
# scale, the logits' largest difference 1.84e-6 of theirs (measured, the
# tail of 1M logits; the S = 12 forward holds ATOL)
LONG_ATOL = 3e-6
CPU = torch.device("cpu")
ARCH = "deepseek-v2-236b"
SMOKE = jax_get_arch(ARCH).smoke_config
NO_QLORA = replace(SMOKE, q_lora_rank=0)


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


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    """The reference's perturbed smoke params, the port's model over them,
    and a numpy batch (B = 2, S = 12)."""
    jp = _perturbed(JT.init_params(jax.random.PRNGKey(0), SMOKE), 50)
    rng = np.random.default_rng(51)
    tokens = rng.integers(0, SMOKE.vocab_size, (2, 12)).astype(np.int32)
    return dict(cfg=SMOKE, jp=jp, model=lm_params_from_jax(jp, SMOKE, CPU),
                tokens=tokens, labels=np.roll(tokens, -1, 1))


@pytest.fixture(scope="module")
def attn():
    """Per attention variant: the reference's perturbed mla_init params
    and the port's over the same weights."""
    out = {}
    for i, cfg in enumerate((SMOKE, NO_QLORA)):
        jp = _perturbed(JL.mla_init(jax.random.PRNGKey(3), cfg), 60 + i)
        out[cfg.q_lora_rank] = (cfg, jp, torch.nn.ParameterDict(
            {k: torch.nn.Parameter(_t(v)) for k, v in jp.items()}))
    return out


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))


def _batch(m, torch_side):
    if torch_side:
        return {"tokens": torch.from_numpy(m["tokens"]),
                "labels": torch.from_numpy(m["labels"])}
    return {"tokens": jnp.asarray(m["tokens"]),
            "labels": jnp.asarray(m["labels"])}


# -- the layer -----------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_init_has_the_reference_leaves(q_lora):
    cfg = replace(SMOKE, q_lora_rank=q_lora)
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in JL.mla_init(jax.random.PRNGKey(0), cfg).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in L.mla_init(torch.Generator().manual_seed(0),
                                  cfg).items()}
    assert got == want
    assert ("wq_a" in got) == bool(q_lora) and ("wq" in got) != bool(q_lora)


@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_q_and_kv_from_latent(attn, q_lora):
    cfg, jp, p = attn[q_lora]
    x, pos = _x(cfg, 2, 9, 1), _positions(2, 9)
    q = L._mla_q(p, cfg, _t(x), _t(pos))
    jq = JL._mla_q(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    assert q.shape == (2, 9, cfg.n_heads, 24)
    _close(q.detach(), jq)
    rng = np.random.default_rng(2)
    c_kv = rng.standard_normal((2, 9, cfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((2, 9, cfg.qk_rope_head_dim)).astype(
        np.float32)
    k, v = L._mla_kv_from_latent(p, cfg, _t(c_kv), _t(k_rope))
    jk, jv = JL._mla_kv_from_latent(jp, cfg, jnp.asarray(c_kv),
                                    jnp.asarray(k_rope))
    assert k.shape == (2, 9, cfg.n_heads, 24) and v.shape == (2, 9, 4, 16)
    _close(k.detach(), jk)
    _close(v.detach(), jv)


@pytest.mark.parametrize("q_lora", [48, 0])
def test_mla_apply_matches_the_reference(attn, q_lora):
    cfg, jp, p = attn[q_lora]
    x, pos = _x(cfg, 2, 12, 4), _positions(2, 12)
    got = L.mla_apply(p, cfg, _t(x), _t(pos))
    want = JL.mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    assert got.shape == (2, 12, cfg.d_model)
    _close(got.detach(), want)


def test_mla_apply_above_chunk_threshold(attn):
    """S = 2048 (CHUNK_THRESHOLD): v padded to q's width 24 through
    chunked_sdpa, cut back to 16, as the reference; equal to sdpa over
    the unequal widths too."""
    cfg, jp, p = attn[48]
    s = L.CHUNK_THRESHOLD
    x, pos = _x(cfg, 1, s, 5), _positions(1, s)
    with torch.no_grad():
        got = L.mla_apply(p, cfg, _t(x), _t(pos))
        q = L._mla_q(p, cfg, _t(x), _t(pos))
        c_kv, k_rope = L._mla_latent(p, cfg, _t(x), _t(pos))
        k, v = L._mla_kv_from_latent(p, cfg, c_kv, k_rope)
        plain = L.sdpa(q, k, v, causal=True).reshape(1, s, -1) @ p["wo"]
    want = JL.mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want)
    _close(got, plain.numpy())


@pytest.fixture(scope="module")
def decode_case(attn):
    """One decode's inputs: x (3, 1, d), a random latent cache of 16
    positions, positions [5, 15, 16] (the last past the cache: dropped),
    kv_valid = pos + 1."""
    cfg, jp, p = attn[48]
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cc = rng.standard_normal((3, 16, cfg.kv_lora_rank)).astype(np.float32)
    ckr = rng.standard_normal((3, 16, cfg.qk_rope_head_dim)).astype(
        np.float32)
    pos = np.array([5, 15, 16], np.int32)
    return cfg, jp, p, x, cc, ckr, pos


@pytest.mark.parametrize("form", ["absorbed", "rebuilt"])
def test_mla_decode_forms_match_the_reference(decode_case, form):
    cfg, jp, p, x, cc, ckr, pos = decode_case
    fn, jfn = {"absorbed": (L.mla_decode_absorbed, JL.mla_decode_absorbed),
               "rebuilt": (L.mla_decode, JL.mla_decode)}[form]
    cache = (_t(cc), _t(ckr))
    with torch.no_grad():
        out, (tc, tkr) = fn(p, cfg, _t(x), _t(pos), cache, _t(pos + 1))
    jout, (jc, jkr) = jfn(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                          (jnp.asarray(cc), jnp.asarray(ckr)),
                          jnp.asarray(pos + 1))
    assert tc is cache[0] and tkr is cache[1]          # written in place
    _close(out, jout)
    _close(tc, jc)
    _close(tkr, jkr)
    assert np.array_equal(tc[2].numpy(), cc[2])       # pos 16: dropped
    assert not np.array_equal(tc[1].numpy(), cc[1])


def test_absorbed_decode_equals_the_rebuilt_one(decode_case):
    """The two decode forms on one cache: equal logits-side outputs and
    equal caches, over a longer cache too."""
    cfg, _, p, x, cc, ckr, pos = decode_case
    rng = np.random.default_rng(10)
    for smax in (16, 300):
        c0 = rng.standard_normal((3, smax, cfg.kv_lora_rank)).astype(
            np.float32)
        r0 = rng.standard_normal((3, smax, cfg.qk_rope_head_dim)).astype(
            np.float32)
        outs = []
        for fn in (L.mla_decode_absorbed, L.mla_decode):
            cache = (_t(c0), _t(r0))
            with torch.no_grad():
                out, cache = fn(p, cfg, _t(x), _t(pos), cache,
                                _t(np.minimum(pos + 1, smax)))
            outs.append((out, cache))
        _close(outs[0][0], outs[1][0].numpy())
        assert torch.equal(outs[0][1][0], outs[1][1][0])
        assert torch.equal(outs[0][1][1], outs[1][1][1])


# -- the model ---------------------------------------------------------------------

def test_init_and_carry_have_the_reference_leaves(model):
    cfg, jp = model["cfg"], model["jp"]
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in lm_named_from_jax(jp, CPU).items()}
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    got = {k: (tuple(v.shape), v.dtype) for k, v in mine.named_parameters()}
    assert got == want
    assert "blocks.1.attn.wkv_b" in got and "blocks.0.ffn.w_up" in got
    carried = dict(model["model"].named_parameters())
    assert np.array_equal(carried["blocks.1.attn.wkv_b"].detach().numpy(),
                          np.asarray(jp["layers"]["attn"]["wkv_b"][0]))
    assert np.array_equal(carried["blocks.0.attn.wq_b"].detach().numpy(),
                          np.asarray(jp["dense_layers"][0]["attn"]["wq_b"]))


def test_init_cache_has_the_mla_layout(model):
    cfg = model["cfg"]
    cache = T.init_cache(cfg, 3, 20, CPU)
    ref = JT.init_cache(cfg, 3, 20)
    assert cache.a.shape == ref.a.shape == (2, 3, 20, 32)
    assert cache.b.shape == ref.b.shape == (2, 3, 20, 8)
    assert cache.a.dtype == torch.float32 and cache.length.tolist() == [0] * 3
    big = T.init_cache(replace(jax_get_arch(ARCH).config, n_layers=1), 1, 2,
                       CPU)
    assert big.a.shape == (1, 1, 2, 512) and big.b.shape == (1, 1, 2, 64)
    assert big.a.dtype == torch.bfloat16


def test_forward_logits(model):
    got, aux = T.forward(model["model"], SMOKE,
                         torch.from_numpy(model["tokens"]))
    want, jaux = JT.forward(model["jp"], SMOKE, jnp.asarray(model["tokens"]))
    _close(got.detach(), want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_forward_through_chunked_attention(model):
    """S = 2048 sends every MLA layer through the padded chunked path."""
    tokens = np.random.default_rng(3).integers(
        0, SMOKE.vocab_size, (1, 2048)).astype(np.int32)
    with torch.no_grad():
        got, aux = T.forward(model["model"], SMOKE, torch.from_numpy(tokens))
    want, jaux = JT.forward(model["jp"], SMOKE, jnp.asarray(tokens))
    _close(got, want, atol=LONG_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_lm_loss_matches(model):
    total, met = T.lm_loss(model["model"], SMOKE, _batch(model, True))
    jtotal, jmet = JT.lm_loss(model["jp"], SMOKE, _batch(model, False))
    _close(total.detach(), jtotal)
    for key in ("loss", "aux", "ppl"):
        _close(met[key].detach(), jmet[key])


@pytest.fixture(scope="module")
def ref_grads(model):
    (_, _), g = jax.jit(jax.value_and_grad(
        lambda p: JT.lm_loss(p, SMOKE, _batch(model, False)),
        has_aux=True))(model["jp"])
    return g, lm_named_from_jax(g, CPU)


def test_gradients_match_value_and_grad(model, ref_grads):
    ps = dict(model["model"].named_parameters())
    loss, _ = T.lm_loss(model["model"], SMOKE, _batch(model, True))
    grads = torch.autograd.grad(loss, list(ps.values()))
    want = ref_grads[1]
    assert set(ps) == set(want)
    for (n, _), g in zip(ps.items(), grads):
        atol = ROUTER_GRAD_ATOL if n.endswith("router") else GRAD_ATOL
        _close(g, want[n], atol=atol, err_msg=n)


def test_one_adamw_step_on_the_reference_gradients(model, ref_grads):
    jopt, opt = jax_adamw(3e-4), adamw(3e-4)
    jg, named = ref_grads
    jnew, jstate, jmet = jax.jit(jopt.update)(jg, jopt.init(model["jp"]),
                                              model["jp"])
    mine = lm_params_from_jax(model["jp"], SMOKE, CPU)
    _, state, met = opt.update({k: v.clone() for k, v in named.items()},
                               opt.init(mine), mine)
    _close(met["grad_norm"], jmet["grad_norm"])
    want = lm_named_from_jax(jnew, CPU)
    for n, p in mine.named_parameters():
        _close(p.detach(), want[n], err_msg=n)
    for key in ("m", "v"):
        for n, t in lm_named_from_jax(jstate[key], CPU).items():
            _close(state[key][n], t, err_msg=f"{key} {n}")


def test_prefill_then_decode_matches_forward(model):
    """Prefill 8 tokens into a 12-slot latent cache, decode 4 of the
    reference's greedy ids through the absorbed form: each step equals
    the reference's decode and the port's forward over the 12 tokens;
    the caches equal the reference's."""
    prompt = model["tokens"][:, :8]
    logits, cache = T.prefill(model["model"], SMOKE,
                              torch.from_numpy(prompt), max_len=12)
    jl, jc = jax.jit(JT.prefill, static_argnums=(1, 3))(
        model["jp"], SMOKE, jnp.asarray(prompt), 12)
    _close(logits, np.asarray(jl))
    _close(cache.a, jc.a)
    _close(cache.b, jc.b)
    jdecode = jax.jit(JT.decode_step, static_argnums=1)
    want = np.asarray(jl[:, -1])
    seq, steps = [prompt], []
    for i in range(4):
        tok = want.argmax(-1).astype(np.int32)
        seq.append(tok[:, None])
        pos = np.full((2,), 8 + i, np.int32)
        got, cache = T.decode_step(model["model"], SMOKE,
                                   torch.from_numpy(tok), cache,
                                   torch.from_numpy(pos))
        jlg, jc = jdecode(model["jp"], SMOKE, jnp.asarray(tok), jc,
                          jnp.asarray(pos))
        want = np.asarray(jlg)
        _close(got, want)
        steps.append(got)
    with torch.no_grad():
        fwd, _ = T.forward(model["model"], SMOKE,
                           torch.from_numpy(np.concatenate(seq, axis=1)))
    for i, lg in enumerate(steps):
        _close(lg, fwd[:, 8 + i])
    _close(cache.a, jc.a)
    _close(cache.b, jc.b)
    assert np.array_equal(cache.length.numpy(), np.asarray(jc.length))


def test_serve_steps_drop_the_write_past_the_prompt(model):
    """The reference's tests/test_smoke_archs.py contract: a prefill
    without max_len sizes the latent cache to the 12-token prompt, the
    decode at pos 12 drops its write, lengths 13, finite logits equal to
    the reference's."""
    toks = model["tokens"]
    last, cache = lm_prefill_step(SMOKE)(model["model"],
                                         torch.from_numpy(toks))
    jlast, jc = jax.jit(jax_prefill_step(SMOKE))(model["jp"],
                                                 jnp.asarray(toks))
    assert last.shape == (2, SMOKE.vocab_size)
    _close(last, jlast)
    before = cache.a.clone(), cache.b.clone()
    pos = np.full((2,), 12, np.int32)
    logits, cache = lm_decode_step(SMOKE)(model["model"],
                                          last.argmax(-1).int(), cache,
                                          torch.from_numpy(pos))
    jlogits, jc = jax.jit(jax_decode_step(SMOKE))(
        model["jp"], jnp.argmax(jlast, -1).astype(jnp.int32), jc,
        jnp.asarray(pos))
    _close(logits, jlogits)
    assert torch.isfinite(logits).all()
    assert cache.length.tolist() == [13, 13] == np.asarray(jc.length).tolist()
    assert torch.equal(cache.a, before[0]) and torch.equal(cache.b, before[1])


# -- the launchers -------------------------------------------------------------------

def test_serve_launcher_prints_the_reference_line(capsys):
    serve_main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--tokens", "4"])
    out = capsys.readouterr().out
    assert re.fullmatch(re.escape(ARCH) + r": prefill\(32\) \+ decode\(4\) "
                        r"for batch 2 in \d+\.\d\ds \(\d+\.\d tok/s\)\n",
                        out), out


def test_train_launcher_trains_the_mla_lm(tmp_path, capsys):
    train_main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq",
                "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"deepseek-v2-236b: trained 2 steps; "
                        r"history=\[\d+\.\d+, \d+\.\d+\]", line), line
    spec, ref = get_arch(ARCH), jax_get_arch(ARCH)
    assert vars(spec.config) == vars(ref.config)
    assert vars(spec.smoke_config) == vars(ref.smoke_config)
    assert spec.skip_reason("long_500k") and ref.skip_reason("long_500k")
