"""The port's dense decoder LM (``models/transformer.py``, ``lm_loss`` under
both cross-entropy branches, the gradients, one AdamW step, prefill and
decode, the serve steps, ``serve/sampling.py``, ``lm_batch`` and the
launchers) against the reference's, on the CPU.

Each variant's reference params (seed 0) are perturbed in every leaf with
numpy and carried with ``lm_params_from_jax``; tokens come from numpy.
Float32 results are held to rtol 1e-5 / atol 1e-6 of the compared
tensor's scale (its largest magnitude), gradients and the optimizer step
to rtol 1e-5 / atol 1e-6 of each leaf's scale (XLA contracts multiply-adds
into fmas, and a logit near zero keeps the rounding of terms of the
logits' own size); token ids must be equal. The bf16
variant (qwen2-1.5b's smoke config in bfloat16) is held to BF16_TOL,
pinned from a measured run (largest logit difference 0.0059 against
logits of scale ~0.5): the two frameworks round bf16 products and sums at
other places.
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
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro.serve.sampling import generate as jax_generate
from repro.serve.sampling import sample_token as jax_sample_token
from repro.serve.serve_step import lm_decode_step as jax_decode_step
from repro.serve.serve_step import lm_prefill_step as jax_prefill_step
from repro_torch import flags
from repro_torch.carry import lm_named_from_jax, lm_params_from_jax
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.sampling import generate, sample_token
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step
from repro_torch.train.train_step import loss_fn_for, make_train_step

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 3e-6
BF16_TOL = dict(rtol=0.0, atol=0.03)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs (the suite runs
    in several worker processes)."""
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


def _close_leaf(got, want, name, atol=ATOL):
    """rtol 1e-5 / atol of the leaf's own scale."""
    _close(got, want, atol=atol, err_msg=name)


def _ids_agree(got_logits, want_logits, tol: float = 0.0):
    """Greedy ids of (B, V) logits: equal, except where the reference's
    top two lie within 2 * tol, where the port's pick must be within
    2 * tol of the reference's top."""
    got = np.asarray(got_logits, np.float32)
    want = np.asarray(want_logits, np.float32)
    top2 = np.sort(want, axis=-1)[:, -2:]
    pick = got.argmax(-1)
    tie = top2[:, 1] - top2[:, 0] <= 2 * tol
    assert np.array_equal(pick[~tie], want.argmax(-1)[~tie])
    chosen = np.take_along_axis(want, pick[:, None], -1)[:, 0]
    assert (top2[:, 1] - chosen <= 2 * tol).all()


def _variants():
    qwen2 = jax_get_arch("qwen2-1.5b")
    return {"qwen2-1.5b": qwen2.smoke_config,
            "mistral-nemo-12b": jax_get_arch("mistral-nemo-12b").smoke_config,
            "qwen3-32b": jax_get_arch("qwen3-32b").smoke_config,
            "qwen2-1.5b-kv2": jax_reduced_lm(qwen2.config, n_kv_heads=2),
            "qwen2-1.5b-bf16": replace(qwen2.smoke_config,
                                       dtype="bfloat16")}


VARIANTS = _variants()
F32 = [v for v in VARIANTS if not v.endswith("bf16")]


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


@pytest.fixture(scope="module")
def models():
    """Per variant: its config, the reference's perturbed params, the
    port's model over the same weights, and a numpy batch (B = 2, S =
    12)."""
    out = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        jp = _perturbed(JT.init_params(jax.random.PRNGKey(0), cfg), 10 + i)
        rng = np.random.default_rng(20 + i)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        out[name] = dict(cfg=cfg, jp=jp,
                         model=lm_params_from_jax(jp, cfg, CPU),
                         tokens=tokens, labels=np.roll(tokens, -1, 1))
    return out


def _batch(m, torch_side):
    if torch_side:
        return {"tokens": torch.from_numpy(m["tokens"]),
                "labels": torch.from_numpy(m["labels"])}
    return {"tokens": jnp.asarray(m["tokens"]),
            "labels": jnp.asarray(m["labels"])}


# -- structure ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_and_carry_have_the_reference_leaves(models, name):
    m = models[name]
    cfg, jp = m["cfg"], m["jp"]
    want = {k: (tuple(v.shape), v.dtype)
            for k, v in lm_named_from_jax(jp, CPU).items()}
    mine = T.init_params(torch.Generator().manual_seed(0), cfg)
    got = {k: (tuple(v.shape), v.dtype) for k, v in mine.named_parameters()}
    assert got == want
    carried = dict(m["model"].named_parameters())
    assert carried.keys() == want.keys()
    assert ("lm_head" in carried) == (not cfg.tie_embeddings)
    leaf = np.asarray(jp["layers"]["attn"]["wq"][1])
    assert np.array_equal(carried["blocks.1.attn.wq"].detach().float().numpy(),
                          leaf.astype(np.float32))


def test_moe_and_mla_raise_naming_their_item():
    """Item 10.6b is ported: both configs build ``init_params`` and
    ``init_cache`` with the reference's leaves, shapes and types."""
    for arch in ("deepseek-moe-16b", "deepseek-v2-236b"):
        cfg = jax_get_arch(arch).smoke_config
        jp = JT.init_params(jax.random.PRNGKey(0), cfg)
        want = {k: (tuple(v.shape), v.dtype)
                for k, v in lm_named_from_jax(jp, CPU).items()}
        mine = T.init_params(torch.Generator().manual_seed(0), cfg)
        assert {k: (tuple(v.shape), v.dtype)
                for k, v in mine.named_parameters()} == want
        cache, ref = T.init_cache(cfg, 1, 4, CPU), JT.init_cache(cfg, 1, 4)
        assert cache.a.shape == ref.a.shape and cache.b.shape == ref.b.shape
        assert cache.length.shape == ref.length.shape


# -- forward, loss, gradients, one AdamW step ------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_logits(models, name):
    m = models[name]
    got, aux = T.forward(m["model"], m["cfg"], torch.from_numpy(m["tokens"]))
    want, jaux = JT.forward(m["jp"], m["cfg"], jnp.asarray(m["tokens"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(aux) == float(jaux) == 0.0
    if name.endswith("bf16"):
        _close(got.detach(), want, **BF16_TOL)
    else:
        _close(got.detach(), want)


def test_forward_through_chunked_attention(models):
    """S = 2048 sends the model's attention through chunked_sdpa."""
    m = models["qwen2-1.5b-kv2"]
    tokens = np.random.default_rng(3).integers(
        0, m["cfg"].vocab_size, (1, 2048)).astype(np.int32)
    with torch.no_grad():
        got, _ = T.forward(m["model"], m["cfg"], torch.from_numpy(tokens))
    want, _ = JT.forward(m["jp"], m["cfg"], jnp.asarray(tokens))
    _close(got, want)


@pytest.mark.parametrize("sharded_ce", [False, True])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_lm_loss_under_both_ce_branches(models, name, sharded_ce,
                                        monkeypatch):
    monkeypatch.setattr(flags, "SHARDED_CE", sharded_ce)
    monkeypatch.setattr(jax_flags, "SHARDED_CE", sharded_ce)
    m = models[name]
    total, met = T.lm_loss(m["model"], m["cfg"], _batch(m, True))
    jtotal, jmet = JT.lm_loss(m["jp"], m["cfg"], _batch(m, False))
    tol = dict(rtol=1e-3, atol=0.0) if name.endswith("bf16") else {}
    _close(total.detach(), jtotal, **tol)
    for key in ("loss", "aux", "ppl"):
        _close(met[key].detach(), jmet[key], **tol)


def test_the_two_ce_branches_agree(models, monkeypatch):
    m = models["qwen3-32b"]
    losses = []
    for on in (False, True):
        monkeypatch.setattr(flags, "SHARDED_CE", on)
        losses.append(T.lm_loss(m["model"], m["cfg"], _batch(m, True))[0])
    _close(losses[0].detach(), losses[1].detach())


@pytest.fixture(scope="module")
def ref_grads(models):
    """Per f32 variant: the reference's gradient tree and its port names."""
    out = {}
    for name in F32:
        m = models[name]
        (_, _), g = jax.value_and_grad(
            lambda p: JT.lm_loss(p, m["cfg"], _batch(m, False)),
            has_aux=True)(m["jp"])
        out[name] = (g, lm_named_from_jax(g, CPU))
    return out


@pytest.mark.parametrize("name", F32)
def test_gradients_match_value_and_grad(models, ref_grads, name):
    m = models[name]
    model = m["model"]
    ps = dict(model.named_parameters())
    loss, _ = T.lm_loss(model, m["cfg"], _batch(m, True))
    grads = torch.autograd.grad(loss, list(ps.values()))
    want = ref_grads[name][1]
    assert set(ps) == set(want)
    for (n, _), g in zip(ps.items(), grads):
        _close_leaf(g, want[n], n, atol=GRAD_ATOL)


def test_remat_changes_no_number(models):
    m = models["qwen2-1.5b-kv2"]
    model = m["model"]
    ps = list(model.parameters())
    out = []
    for remat in (True, False):
        loss, _ = T.lm_loss(model, m["cfg"], _batch(m, True), remat=remat)
        out.append([loss] + list(torch.autograd.grad(loss, ps)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-32b"])
def test_one_adamw_step_on_the_reference_gradients(models, ref_grads, name):
    m = models[name]
    jopt, opt = jax_adamw(3e-4), adamw(3e-4)
    jg, named = ref_grads[name]
    jnew, jstate, jmet = jopt.update(jg, jopt.init(m["jp"]), m["jp"])
    model = lm_params_from_jax(m["jp"], m["cfg"], CPU)
    grads = {k: v.clone() for k, v in named.items()}
    _, state, met = opt.update(grads, opt.init(model), model)
    _close(met["grad_norm"], jmet["grad_norm"])
    want = lm_named_from_jax(jnew, CPU)
    for n, p in model.named_parameters():
        _close_leaf(p.detach(), want[n], n)
    for key in ("m", "v"):
        for n, t in lm_named_from_jax(jstate[key], CPU).items():
            _close_leaf(state[key][n], t, f"{key} {n}")


def test_train_step_takes_the_reference_loss(models):
    m = models["mistral-nemo-12b"]
    model = lm_params_from_jax(m["jp"], m["cfg"], CPU)
    opt = adamw(3e-4)
    step = make_train_step(loss_fn_for("lm", m["cfg"]), opt, microbatches=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, _, met = step(model, opt.init(model), _batch(m, True))
    # the last microbatch's loss: rows 1 of the reference's batch
    half = {k: v[1:] for k, v in _batch(m, False).items()}
    _close(met["loss"], JT.lm_loss(m["jp"], m["cfg"], half)[1]["loss"])
    assert np.isfinite(float(met["grad_norm"])) and float(met["grad_norm"]) > 0
    assert all(not torch.equal(p, before[n])
               for n, p in model.named_parameters())


# -- prefill, decode, the serve steps ---------------------------------------------------

@pytest.mark.parametrize("name", F32)
def test_prefill_matches_forward_and_the_reference(models, name):
    m = models[name]
    cfg, toks = m["cfg"], m["tokens"]
    logits, cache = T.prefill(m["model"], cfg, torch.from_numpy(toks),
                              max_len=16)
    jl, jc = JT.prefill(m["jp"], cfg, jnp.asarray(toks), max_len=16)
    _close(logits, jl)
    _close(logits, JT.forward(m["jp"], cfg, jnp.asarray(toks))[0])
    assert cache.a.shape == jc.a.shape == (cfg.n_layers, 2, 16,
                                           cfg.n_kv_heads, cfg.head_dim)
    _close(cache.a, jc.a)
    _close(cache.b, jc.b)
    assert np.array_equal(cache.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_then_decode_matches_forward(models, name):
    """Prefill 8 tokens into a 12-slot cache, decode 4 greedily: the ids
    and each step's logits equal the reference's decode and the port's
    forward over the 12 tokens; the cache equals the reference's. Both
    decode the reference's ids, so a bf16 tie cannot fork the runs."""
    m = models[name]
    cfg = m["cfg"]
    bf16 = name.endswith("bf16")
    tol = BF16_TOL if bf16 else {}
    prompt = m["tokens"][:, :8]
    logits, cache = T.prefill(m["model"], cfg, torch.from_numpy(prompt),
                              max_len=12)
    jl, jc = JT.prefill(m["jp"], cfg, jnp.asarray(prompt), max_len=12)
    got, want = logits[:, -1], np.asarray(jl[:, -1])
    seq, steps = [prompt], []
    for i in range(4):
        tie = tol["atol"] * float(np.abs(want).max()) if bf16 else 0.0
        _ids_agree(got, want, tie)
        tok = want.argmax(-1).astype(np.int32)
        seq.append(tok[:, None])
        pos = np.full((2,), 8 + i, np.int32)
        got, cache = T.decode_step(m["model"], cfg, torch.from_numpy(tok),
                                   cache, torch.from_numpy(pos))
        jlg, jc = JT.decode_step(m["jp"], cfg, jnp.asarray(tok), jc,
                                 jnp.asarray(pos))
        want = np.asarray(jlg)
        _close(got, want, **tol)
        steps.append(got)
    assert np.array_equal(cache.length.numpy(), np.asarray(jc.length))
    full = np.concatenate(seq, axis=1)                      # (2, 12)
    with torch.no_grad():
        fwd, _ = T.forward(m["model"], cfg, torch.from_numpy(full))
    for i, lg in enumerate(steps):
        _close(lg, fwd[:, 8 + i], **tol)
    _close(cache.a.float(), np.asarray(jc.a.astype(jnp.float32)), **tol)
    _close(cache.b.float(), np.asarray(jc.b.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("name", ["qwen3-32b", "qwen2-1.5b-kv2"])
def test_serve_steps_drop_the_write_past_the_prompt(models, name):
    """The reference's serve steps (tests/test_smoke_archs.py): a prefill
    without max_len sizes the cache to the prompt, so decoding at pos == S
    drops the cache write and only the lengths move."""
    m = models[name]
    cfg, toks = m["cfg"], m["tokens"]
    last, cache = lm_prefill_step(cfg)(m["model"], torch.from_numpy(toks))
    jlast, jc = jax_prefill_step(cfg)(m["jp"], jnp.asarray(toks))
    assert last.shape == (2, cfg.vocab_size)
    _close(last, jlast)
    before = cache.a.clone(), cache.b.clone()
    tok = last.argmax(-1).int()
    pos = np.full((2,), 12, np.int32)
    logits, cache = lm_decode_step(cfg)(m["model"], tok, cache,
                                        torch.from_numpy(pos))
    jlogits, jc = jax_decode_step(cfg)(m["jp"], jnp.argmax(jlast, -1).astype(
        jnp.int32), jc, jnp.asarray(pos))
    _close(logits, jlogits)
    assert torch.isfinite(logits).all()
    assert cache.length.tolist() == [13, 13] == np.asarray(jc.length).tolist()
    assert torch.equal(cache.a, before[0]) and torch.equal(cache.b, before[1])


# -- sampling ------------------------------------------------------------------------

def test_sample_token_greedy_topk_and_passed_draws():
    logits = np.array([[0.0, 5.0, 1.0], [3.0, 0.0, -1.0]], np.float32)
    t = torch.from_numpy(logits)
    assert sample_token(t, temperature=0.0).tolist() == [1, 0]
    assert sample_token(t, temperature=0.0).dtype == torch.int32
    # top_k=1 sampling == greedy regardless of temperature or draw
    for seed in range(5):
        g = torch.Generator().manual_seed(seed)
        assert sample_token(t, temperature=2.0, top_k=1,
                            generator=g).tolist() == [1, 0]
    # sampled: the reference's own Gumbel draw, passed in
    rng = np.random.default_rng(0)
    wide = rng.standard_normal((64, 503)).astype(np.float32)
    for i, (temp, k) in enumerate([(1.0, 0), (0.7, 0), (1.3, 20)]):
        key = jax.random.PRNGKey(i)
        want = jax_sample_token(key, jnp.asarray(wide), temperature=temp,
                                top_k=k)
        draw = jax.random.gumbel(key, wide.shape, jnp.float32)
        got = sample_token(torch.from_numpy(wide), temperature=temp,
                           top_k=k, gumbel=torch.from_numpy(np.array(draw)))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert len(set(got.tolist())) > 1


def test_sample_token_draws_from_the_generator():
    logits = torch.zeros((4000, 4))
    a = sample_token(logits, generator=torch.Generator().manual_seed(1))
    b = sample_token(logits, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    counts = torch.bincount(a.long(), minlength=4).float() / 4000
    assert float((counts - 0.25).abs().max()) < 0.03


def _padded_prompt_cache(m, torch_side):
    toks = np.pad(m["tokens"][:, :8], ((0, 0), (0, 6)))
    if torch_side:
        return lm_prefill_step(m["cfg"])(m["model"], torch.from_numpy(toks))
    return jax_prefill_step(m["cfg"])(m["jp"], jnp.asarray(toks))


def test_generate_loop_matches_stepwise_and_the_reference(models):
    """The reference's test_generate_loop_matches_stepwise: two greedy
    runs from one cache. The port writes that cache in place, and the
    second run still gives the first's ids (each step reads only the
    positions it has just rewritten); both equal the reference's."""
    m = models["qwen2-1.5b"]
    cfg = m["cfg"]
    last, cache = _padded_prompt_cache(m, True)
    first = last.argmax(-1).int()
    pos0 = torch.full((2,), 8, dtype=torch.int32)
    out, _ = generate(m["model"], cfg, lm_decode_step(cfg), cache, first,
                      pos0, 4, temperature=0.0)
    out2, _ = generate(m["model"], cfg, lm_decode_step(cfg), cache, first,
                       pos0, 4, temperature=0.0)
    assert torch.equal(out, out2) and out.shape == (2, 4)
    jlast, jcache = _padded_prompt_cache(m, False)
    jout, _ = jax_generate(m["jp"], cfg, jax.jit(jax_decode_step(cfg)),
                           jcache, jnp.argmax(jlast, -1).astype(jnp.int32),
                           jnp.full((2,), 8, jnp.int32), 4, temperature=0.0)
    assert np.array_equal(out.numpy(), np.asarray(jout))


def test_sampled_generate_with_the_reference_draws(models):
    m = models["qwen3-32b"]
    cfg = m["cfg"]
    key = jax.random.PRNGKey(5)
    jlast, jcache = _padded_prompt_cache(m, False)
    first = jnp.argmax(jlast, -1).astype(jnp.int32)
    jout, _ = jax_generate(m["jp"], cfg, jax_decode_step(cfg), jcache, first,
                           jnp.full((2,), 8, jnp.int32), 4, key=key,
                           temperature=1.0, top_k=50)
    draws, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(jax.random.gumbel(
            sub, (2, cfg.vocab_size), jnp.float32))))
    _, cache = _padded_prompt_cache(m, True)
    out, _ = generate(m["model"], cfg, lm_decode_step(cfg), cache,
                      torch.from_numpy(np.array(first)),
                      torch.full((2,), 8, dtype=torch.int32), 4,
                      temperature=1.0, top_k=50, gumbels=draws)
    assert np.array_equal(out.numpy(), np.asarray(jout))


# -- data and launchers ----------------------------------------------------------------

def test_lm_batch():
    b = lm_batch(torch.Generator().manual_seed(0), 3, 10, 503)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (3, 10)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 503
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mistral-nemo-12b",
                                  "qwen3-32b"])
def test_serve_launcher_prints_the_reference_line(arch, capsys):
    serve_main(["--arch", arch, "--device", "cpu", "--batch", "2",
                "--tokens", "4"])
    out = capsys.readouterr().out
    assert re.fullmatch(re.escape(arch) + r": prefill\(32\) \+ decode\(4\) "
                        r"for batch 2 in \d+\.\d\ds \(\d+\.\d tok/s\)\n",
                        out), out


def test_train_launcher_trains_the_lm(tmp_path, capsys):
    train_main(["--arch", "qwen2-1.5b", "--steps", "2", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--ckpt-dir",
                str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"qwen2-1\.5b: trained 2 steps; "
                        r"history=\[\d+\.\d+, \d+\.\d+\]", line), line
    assert get_arch("qwen2-1.5b").family == "lm"
