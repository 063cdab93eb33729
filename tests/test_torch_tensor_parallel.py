"""The dense LMs' tensor-parallel programs (``sharding.shard_lm``,
``distributed.tensor_parallel``, ``mesh=`` on ``models.transformer``'s
entry points and on the train and serve steps) against the unsharded port
and the reference on carried weights, on the CPU: meshes (1, 2), (2, 2) and
(1, 4) naming the CPU once per device, ``HEAD_TP_ATTENTION`` and
``SHARDED_CE`` each on and off; and the count of a meta (2, 4) mesh
against the reference's step partitioned by XLA over 8 forced host
devices.

The models are reduced qwen2-1.5b and qwen3-32b with a vocabulary of 512
on both sides (the reduced 503 is prime: the rules' guard would replicate
``embed`` and the head, and the vocabulary split would never run), and
qwen3-32b's with 2 KV heads, whose cache splits on KV heads where 2
divides ``model``. Tolerances are the ground rules': logits and losses
rtol 1e-5 / atol 1e-6 of the compared tensor's scale, gradients and one
AdamW step rtol 1e-5 / atol GRAD_ATOL of each leaf's scale, as
``tests/test_torch_transformer.py`` holds the unsharded port."""
import json
import math
import os
import subprocess
import sys
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
from repro_torch import flags
from repro_torch.analysis import op_costs
from repro_torch.analysis.op_costs import CostCounter
from repro_torch.carry import lm_named_from_jax, lm_params_from_jax
from repro_torch.configs import get_arch, reduced_lm
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adamw
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step
from repro_torch.train.train_step import loss_fn_for, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 3e-6
CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2), (1, 4)]
VOCAB = 512
B, S = 4, 16
# the port's per-device FLOPs of a train step on a meta (2, 4) mesh over
# hlo_costs of the reference's step partitioned on 8 host devices: +1.23%
# (mistral-nemo-12b), +1.25% (qwen2-1.5b), +1.29% (qwen3-32b) measured
# (K / V's projections split then gathered, the norms and rope of K
# replicated, where XLA gathered the weights); held to 2.5%
COUNT_RTOL = 0.025
COUNTED = ["qwen2-1.5b", "qwen3-32b", "mistral-nemo-12b"]
_COUNT: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_count():
    """The reference's partitioned compiles (``_REF_COUNT``), started in a
    process of their own as the module begins and read by
    ``test_meta_count_matches_the_reference_partition``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_COUNT, *COUNTED],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    _COUNT["proc"] = proc
    yield
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs (the suite runs
    in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variants():
    qwen3 = jax_get_arch("qwen3-32b").config
    return {"qwen2-1.5b": jax_reduced_lm(jax_get_arch("qwen2-1.5b").config,
                                         vocab_size=VOCAB),
            "qwen3-32b": jax_reduced_lm(qwen3, vocab_size=VOCAB),
            "qwen3-32b-kv2": jax_reduced_lm(qwen3, vocab_size=VOCAB,
                                            n_kv_heads=2)}


VARIANTS = _variants()


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        spread = float(a.std()) or 1.0
        return jnp.asarray(a + (rng.standard_normal(a.shape) * 0.1
                                * spread).astype(np.float32))
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def models():
    """Per variant: its config, the reference's perturbed params, the
    port's model over the same weights, and a numpy batch (B x S)."""
    out = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        jp = _perturbed(JT.init_params(jax.random.PRNGKey(0), cfg), 30 + i)
        tokens = np.random.default_rng(40 + i).integers(
            0, VOCAB, (B, S)).astype(np.int32)
        out[name] = dict(cfg=cfg, jp=jp,
                         model=lm_params_from_jax(jp, cfg, CPU),
                         tokens=tokens, labels=np.roll(tokens, -1, 1))
    return out


def _mesh(shape, device=CPU):
    return make_host_mesh(*shape, devices=[device] * math.prod(shape))


def _batch(m, torch_side=True):
    wrap = torch.from_numpy if torch_side else jnp.asarray
    return {"tokens": wrap(m["tokens"]), "labels": wrap(m["labels"])}


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    """rtol, and atol times the largest magnitude of ``want``."""
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=rtol, atol=atol * scale, **kw)


def _joined(sm, tensors: dict) -> dict:
    """{ShardedLM parameter name: tensor} -> {TransformerLM name: tensor},
    each split leaf's shards joined on its split dimension."""
    n = len(sm.shards)
    out = {}
    for name, d in sm.dims.items():
        if d is None:
            out[name] = tensors[f"shards.0.{name}"]
        else:
            out[name] = torch.cat([tensors[f"shards.{s}.{name}"]
                                   for s in range(n)], dim=d)
    return out


def _flags(monkeypatch, head_tp=False, sharded_ce=False):
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", head_tp)
    monkeypatch.setattr(flags, "SHARDED_CE", sharded_ce)
    monkeypatch.setattr(jax_flags, "SHARDED_CE", sharded_ce)


_REF: dict = {}


def _reference(m, name, sharded_ce):
    """The reference's loss and gradients on ``m``'s batch, under
    ``sharded_ce`` (computed once per variant and branch)."""
    key = (name, sharded_ce)
    if key not in _REF:
        old = jax_flags.SHARDED_CE
        jax_flags.SHARDED_CE = sharded_ce
        try:
            (loss, _), g = jax.value_and_grad(
                lambda p: JT.lm_loss(p, m["cfg"], _batch(m, False)),
                has_aux=True)(m["jp"])
        finally:
            jax_flags.SHARDED_CE = old
        _REF[key] = (float(loss), g, lm_named_from_jax(g, CPU))
    return _REF[key]


# ------------------------------------------------------- the weights
def test_shard_lm_slices_views_and_unshards(models):
    """Each split leaf's shard s is its block of the model's parameter (a
    view of it), a replicated leaf is the one object every shard module
    holds, ``named_parameters`` lists each leaf once, and ``unshard_lm``
    gives the model back bit for bit."""
    m = models["qwen3-32b"]
    model, mesh = m["model"], _mesh((1, 4))
    sm = SH.shard_lm(model, mesh)
    params = dict(model.named_parameters())
    split = [n for n, d in sm.dims.items() if d is not None]
    assert {"embed", "blocks.0.attn.wq", "blocks.0.attn.wo",
            "blocks.1.ffn.w_down"} <= set(split)
    assert sm.dims["blocks.0.attn.wq"] == 1 and sm.dims["embed"] == 0
    assert sm.dims["blocks.0.attn.wo"] == 0
    assert sm.dims["blocks.0.ln1"] is None
    for s, shard in enumerate(sm.shards):
        mine = dict(shard.named_parameters())
        for n in split:
            d = sm.dims[n]
            w = params[n].shape[d] // 4
            assert torch.equal(mine[n], params[n].narrow(d, s * w, w))
            assert mine[n].untyped_storage().data_ptr() == \
                params[n].untyped_storage().data_ptr()
        assert mine["blocks.1.ln2"] is dict(
            sm.shards[0].named_parameters())["blocks.1.ln2"]
    n_rep = len(sm.dims) - len(split)
    assert len(list(sm.parameters())) == n_rep + 4 * len(split)
    assert set(sm.device_names()) <= {n for n, _ in sm.named_parameters()}
    back = dict(SH.unshard_lm(sm).named_parameters())
    assert back.keys() == params.keys()
    assert all(torch.equal(back[n], p) for n, p in params.items())


def test_a_dimension_that_does_not_divide_is_replicated(models):
    """On a (1, 3) mesh nothing of the reduced model divides: every leaf
    is replicated (the reference's guard), attention, the SwiGLU, the
    lookup and the head run replicated, and the logits are the unsharded
    port's."""
    m = models["qwen2-1.5b"]
    mesh = _mesh((1, 3))
    sm = SH.shard_lm(m["model"], mesh)
    assert all(d is None for d in sm.dims.values())
    assert len(list(sm.parameters())) == len(list(m["model"].parameters()))
    tokens = torch.from_numpy(m["tokens"][:, :15])
    with torch.no_grad():
        got, _ = T.forward(sm, m["cfg"], tokens, mesh=mesh)
        want, _ = T.forward(m["model"], m["cfg"], tokens)
    _close(got, want)


def test_batch_seq_spec_is_the_reference_rule():
    mesh = make_host_mesh(2, 4, devices=[torch.device("meta")] * 8)
    assert SH.batch_seq_spec(mesh, (4, 16), 0, 1) == (("data",), "model")
    assert SH.batch_seq_spec(mesh, (3, 16), 0, 1) == (None, "model")
    assert SH.batch_seq_spec(mesh, (4, 6), 0, 1) == (("data",), None)
    assert SH.batch_seq_spec(mesh, (4, 16)) == (("data",), None)
    pod = make_host_mesh(2, 2, pod=2, devices=[torch.device("meta")] * 8)
    assert SH.batch_seq_spec(pod, (8, 4, 3), 0, 1) == (("pod", "data"),
                                                       "model", None)


# ----------------------------------------------------- the collectives
def test_collectives_move_and_price_as_the_reference():
    """On a (1, 2) CPU mesh: all_reduce sums in shard order, fan_out's
    backward sums the copies (an all-reduce), a gather to every shard
    hands each its slice back (a reduce-scatter), all_to_all is undone by
    its backward; each priced once per direction with hlo.py's wire
    factors."""
    grp = TP.Group(_mesh((1, 2)))
    x = torch.randn(3, 4, requires_grad=True)
    parts = [torch.randn(3, 4, requires_grad=True) for _ in range(2)]
    with CostCounter() as c:
        total = TP.all_reduce(grp, parts)
        copies = TP.fan_out(grp, x)
        (copies[0] * 2 + copies[1] * 3).sum().backward()
        full = TP.all_gather_to_shards(grp, parts, dim=1)
        (full[0] * 5 + full[1] * 7).sum().backward()
        y = torch.randn(4, 3)
        swapped = TP.all_to_all(grp, [y, y * 2.0], 0, 1)
        back = TP.all_to_all(grp, swapped, 1, 0)
    assert torch.equal(total, parts[0] + parts[1])
    assert torch.equal(x.grad, torch.full((3, 4), 5.0))
    assert torch.equal(parts[0].grad, torch.full((3, 4), 12.0))
    assert swapped[0].shape == (2, 6) and torch.equal(back[1], y * 2.0)
    assert torch.equal(swapped[1], torch.cat([y[2:], y[2:] * 2.0], dim=1))
    counts = c.per_device().collective_counts
    assert dict(counts) == {"all-reduce": 2, "all-gather": 1,
                            "reduce-scatter": 1, "all-to-all": 2}
    nb = 3 * 4 * 4
    assert c.per_device().link_bytes == pytest.approx(
        2 * nb * 2 * 0.5 + 2 * nb * 0.5 + nb * 1 + 2 * nb * 0.5)


# ------------------------------------------------ forward, loss, grads
@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-32b"])
def test_forward_logits(models, name, shape, head_tp, monkeypatch):
    _flags(monkeypatch, head_tp=head_tp)
    m = models[name]
    mesh = _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    tokens = torch.from_numpy(m["tokens"])
    with torch.no_grad():
        got, aux = T.forward(sm, m["cfg"], tokens, mesh=mesh)
        mine, _ = T.forward(m["model"], m["cfg"], tokens)
    want, _ = JT.forward(m["jp"], m["cfg"], jnp.asarray(m["tokens"]))
    assert got.shape == (B, S, VOCAB) and float(aux) == 0.0
    _close(got, mine)
    _close(got, want)


_PORT: dict = {}


def _port_grads(m, name, sharded_ce):
    """The unsharded port's gradients on ``m``'s batch (once per variant
    and branch)."""
    key = (name, sharded_ce)
    if key not in _PORT:
        ps = dict(m["model"].named_parameters())
        loss, _ = T.lm_loss(m["model"], m["cfg"], _batch(m))
        _PORT[key] = dict(zip(ps, torch.autograd.grad(loss,
                                                      list(ps.values()))))
    return _PORT[key]


@pytest.mark.parametrize("sharded_ce", [False, True])
@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-32b"])
def test_loss_and_gradients(models, name, shape, head_tp, sharded_ce,
                            monkeypatch):
    """The loss against the reference's; every leaf's gradient (the
    shards' joined) against the unsharded port's, and against
    ``jax.value_and_grad`` of the reference within GRAD_ATOL of the leaf's
    scale or twice the unsharded port's own distance to it, whichever is
    larger: a leaf whose sum cancels (the keys' bias, rotated by rope)
    keeps the rounding of its terms, and the unsharded port lies 3.2e-6 of
    that leaf's scale from the reference on this batch (the sharded
    programs 4.4e-6 at most)."""
    _flags(monkeypatch, head_tp, sharded_ce)
    m = models[name]
    mesh = _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    loss, met = T.lm_loss(sm, m["cfg"], _batch(m), mesh=mesh)
    ps = dict(sm.named_parameters())
    grads = torch.autograd.grad(loss, list(ps.values()))
    want_loss, _, want = _reference(m, name, sharded_ce)
    _close(loss.detach(), want_loss)
    _close(met["ppl"].detach(), math.exp(want_loss))
    got = _joined(sm, dict(zip(ps, grads)))
    port = _port_grads(m, name, sharded_ce)
    assert got.keys() == want.keys() == port.keys()
    for n, g in got.items():
        _close(g, port[n], atol=GRAD_ATOL, err_msg=n)
        w = want[n].numpy()
        own = float(np.abs(port[n].numpy() - w).max())
        limit = max(GRAD_ATOL * float(np.abs(w).max()), 2 * own)
        assert float(np.abs(g.numpy() - w).max()) <= limit, n


@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-32b"])
def test_one_adamw_step_on_the_reference_gradients(models, name):
    """AdamW over a ``ShardedLM``'s leaves, fed the reference's gradients
    cut into shards, equals the reference's step on every leaf and
    moment."""
    m = models[name]
    mesh = _mesh((2, 2))
    model = lm_params_from_jax(m["jp"], m["cfg"], CPU)
    sm = SH.shard_lm(model, mesh)
    _, jg, named = _reference(m, name, False)
    jopt, opt = jax_adamw(3e-4), adamw(3e-4)
    jnew, jstate, jmet = jopt.update(jg, jopt.init(m["jp"]), m["jp"])
    grads = {}
    for pn, p in sm.named_parameters():
        s, name_ = int(pn.split(".")[1]), pn.split(".", 2)[2]
        d = sm.dims[name_]
        g = named[name_]
        grads[pn] = (g if d is None else g.narrow(
            d, s * p.shape[d], p.shape[d])).clone()
    _, state, met = opt.update(grads, opt.init(sm), sm)
    _close(met["grad_norm"], jmet["grad_norm"])
    want = lm_named_from_jax(jnew, CPU)
    for n, p in SH.unshard_lm(sm).named_parameters():
        _close(p.detach(), want[n], atol=GRAD_ATOL, err_msg=n)
    for key in ("m", "v"):
        got = _joined(sm, state[key])
        for n, t in lm_named_from_jax(jstate[key], CPU).items():
            _close(got[n], t, atol=GRAD_ATOL, err_msg=f"{key} {n}")


def _capture():
    """An optimizer that keeps the gradients it is given and moves
    nothing."""
    seen = {}

    def update(grads, state, params):
        seen.update({k: v.clone() for k, v in grads.items()})
        return params, state, {}
    return Optimizer(lambda p: {}, update), seen


def test_train_step_splits_microbatches_inside_the_groups(models):
    """``make_train_step`` with a mesh and 2 microbatches hands the
    optimizer the unsharded step's gradients (joined) and the last
    microbatch's loss; it prices the data axes' all-reduce of one
    device's gradients once (one per leaf of shard 0)."""
    m = models["qwen3-32b"]
    cfg, mesh = m["cfg"], _mesh((2, 2))
    sm = SH.shard_lm(m["model"], mesh)
    opt, seen = _capture()
    step = make_train_step(loss_fn_for("lm", cfg, mesh=mesh), opt,
                           microbatches=2, mesh=mesh)
    ref_opt, ref_seen = _capture()
    ref = make_train_step(loss_fn_for("lm", cfg), ref_opt, microbatches=2)
    _, _, met = ref(m["model"], {}, _batch(m))
    with CostCounter() as c:
        _, _, got = step(sm, {}, _batch(m))
    _close(got["loss"], met["loss"])
    joined = _joined(sm, seen)
    for n, g in ref_seen.items():
        _close(joined[n], g, atol=GRAD_ATOL, err_msg=n)
    bucket = c.splits[1]
    assert bucket.collective_counts["all-reduce"] == len(sm.device_names())
    per_device = sum(4 * p.numel() for n, p in sm.named_parameters()
                     if n in set(sm.device_names()))
    assert bucket.link_bytes == pytest.approx(per_device * 2 * 0.5)


# ------------------------------------------------ prefill and decode
_SERVED: dict = {}


def _served(m, name):
    """The reference's and the unsharded port's prefill of 8 tokens into a
    16-slot cache and 4 decode steps of the reference's greedy ids: (ids,
    the reference's logits, the port's logits, the port's cache), once per
    variant."""
    if name not in _SERVED:
        cfg = m["cfg"]
        prompt = m["tokens"][:, :8]
        mine, mc = T.prefill(m["model"], cfg, torch.from_numpy(prompt),
                             max_len=16)
        want, jc = JT.prefill(m["jp"], cfg, jnp.asarray(prompt), max_len=16)
        ids, refs, ports = [], [np.asarray(want)], [mine]
        for step in range(4):
            tok = refs[-1][:, -1] if step == 0 else refs[-1]
            ids.append(np.asarray(tok).argmax(-1).astype(np.int32))
            pos = np.full((B,), 8 + step, np.int32)
            mine, mc = T.decode_step(m["model"], cfg,
                                     torch.from_numpy(ids[-1]), mc,
                                     torch.from_numpy(pos))
            want, jc = JT.decode_step(m["jp"], cfg, jnp.asarray(ids[-1]), jc,
                                      jnp.asarray(pos))
            refs.append(np.asarray(want))
            ports.append(mine)
        _SERVED[name] = (ids, refs, ports, mc)
    return _SERVED[name]


@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["qwen2-1.5b", "qwen3-32b-kv2"])
def test_prefill_then_decode(models, name, shape, head_tp, monkeypatch):
    """Prefill 8 tokens into a 16-slot cache, then 4 decode steps of the
    reference's greedy ids: each step's logits equal the unsharded port's
    and the reference's; the cache splits on KV heads where they divide
    ``model`` (qwen3-32b-kv2 on (1, 2) and (2, 2)), else on sequence, and
    holds the unsharded cache's entries."""
    _flags(monkeypatch, head_tp=head_tp)
    m = models[name]
    cfg, mesh = m["cfg"], _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    ids, refs, ports, mc = _served(m, name)
    got, cache = T.prefill(sm, cfg, torch.from_numpy(m["tokens"][:, :8]),
                           max_len=16, mesh=mesh)
    split = "heads" if cfg.n_kv_heads % shape[1] == 0 else "seq"
    assert SH.cache_split(cfg, mesh) == split
    assert split == ("heads" if name.endswith("kv2") and shape[1] == 2
                     else "seq")
    _close(got, ports[0])
    _close(got, refs[0])
    for step in range(4):
        pos = np.full((B,), 8 + step, np.int32)
        got, cache = T.decode_step(sm, cfg, torch.from_numpy(ids[step]),
                                   cache, torch.from_numpy(pos), mesh=mesh)
        _close(got, ports[step + 1])
        _close(got, refs[step + 1])
    assert np.array_equal(cache.length.numpy(), mc.length.numpy())
    groups = len(cache.blocks)
    for i, which in enumerate(("a", "b")):
        rows = [torch.cat([blk[i] for blk in group],
                          dim=3 if split == "heads" else 2)
                for group in cache.blocks]
        _close(torch.cat(rows, dim=1), getattr(mc, which))
    assert groups == shape[0]


def test_serve_steps_take_a_mesh(models, monkeypatch):
    """``lm_prefill_step`` and ``lm_decode_step`` with a mesh give the
    unsharded steps' logits; the prefill's cache holds the prompt."""
    _flags(monkeypatch)
    m = models["qwen2-1.5b"]
    cfg, mesh = m["cfg"], _mesh((2, 2))
    sm = SH.shard_lm(m["model"], mesh)
    tokens = torch.from_numpy(m["tokens"])
    got, cache = lm_prefill_step(cfg, mesh)(sm, tokens)
    want, wc = lm_prefill_step(cfg)(m["model"], tokens)
    _close(got, want)
    assert cache.blocks[0][0][0].shape == (cfg.n_layers, B // 2, S // 2,
                                           cfg.n_kv_heads, cfg.head_dim)
    tok = want.argmax(-1).int()
    pos = torch.full((B,), S - 1, dtype=torch.int32)
    got, _ = lm_decode_step(cfg, mesh)(sm, tok, cache, pos)
    want, _ = lm_decode_step(cfg)(m["model"], tok, wc, pos)
    _close(got, want)


# ------------------------------------ the count against XLA's partition
_REF_COUNT = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import flags
from repro.configs import get_arch
from repro.configs.base import reduced_lm
from repro.distributed import sharding as SH
from repro.models import transformer as T
from repro.optim import adamw
from repro.train.train_step import loss_fn_for, make_train_step
from repro.analysis.hlo_costs import analyze_module
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                         ("data", "model"))
SH.set_active_mesh(mesh)
ns = lambda *s: NamedSharding(mesh, P(*s))
out = {}
for arch in sys.argv[1:]:
    cfg = reduced_lm(get_arch(arch).config, vocab_size=512)
    ps = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
    psh = SH.tree_shardings(mesh, ps, SH.lm_rules(mesh))
    opt = adamw(3e-4)
    tok = jax.ShapeDtypeStruct((4, 64), jnp.int32)
    step = make_train_step(loss_fn_for("lm", cfg), opt)
    text = jax.jit(step, in_shardings=(psh, None, {
        "tokens": ns(("data",), None), "labels": ns(("data",), None)})
        ).lower(ps, jax.eval_shape(opt.init, ps),
                {"tokens": tok, "labels": tok}).compile().as_text()
    out[arch] = analyze_module(text).flops
cfg = reduced_lm(get_arch("qwen2-1.5b").config, vocab_size=512)
flags.HEAD_TP_ATTENTION = True
ps = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
psh = SH.tree_shardings(mesh, ps, SH.lm_rules(mesh))
def prefill(p, t):
    logits, cache = T.prefill(p, cfg, t)
    return logits[:, -1], cache
text = jax.jit(prefill, in_shardings=(psh, ns(("data",), None))).lower(
    ps, jax.ShapeDtypeStruct((2, 2048), jnp.int32)).compile().as_text()
# all-reduces over `model` (groups of 4): (computation, result bytes)
found, where = [], None
for line in text.splitlines():
    if line and not line.startswith(" "):
        where = "entry" if line.startswith("ENTRY") else "body"
    m = re.search(r"= (f32|bf16)\[([0-9,]*)\][^ ]* all-reduce\(", line)
    if m and "replica_groups=[2,4]<=[8]" in line:
        n = int(np.prod([int(d) for d in m.group(2).split(",")]))
        found.append((where, n * (4 if m.group(1) == "f32" else 2)))
out["prefill_all_reduces"] = found
print(json.dumps(out))
"""


def test_meta_count_matches_the_reference_partition(monkeypatch):
    """On a meta (2, 4) mesh: the port's per-device FLOPs of each dense
    LM's reduced train step (B = 4, S = 64, default flags) within
    COUNT_RTOL of ``hlo_costs`` on the reference's step compiled with the
    rules' shardings over 8 forced host devices; and under head-TP a
    prefill of 2 x 2,048 (chunked attention) all-reduces over ``model``
    as XLA does: the lookup's once, two a layer (``wo``, ``w_down``), each
    of one group's (B, S, d) activations."""
    archs = COUNTED
    out, err = _COUNT["proc"].communicate(timeout=600)
    assert _COUNT["proc"].returncode == 0, err[-3000:]
    ref = json.loads(out)
    meta = torch.device("meta")
    mesh = make_host_mesh(2, 4, devices=[meta] * 8)
    _flags(monkeypatch)
    for arch in archs:
        cfg = replace(reduced_lm(get_arch(arch).config), vocab_size=VOCAB)
        sm = SH.shard_lm(T.init_params(torch.Generator().manual_seed(0), cfg,
                                       device=meta), mesh)
        opt = adamw(3e-4)
        step = make_train_step(loss_fn_for("lm", cfg, mesh=mesh), opt,
                               mesh=mesh)
        t = torch.empty((4, 64), dtype=torch.int32, device=meta)
        with CostCounter() as c:
            step(sm, opt.init(sm), {"tokens": t, "labels": t})
        got = c.per_device().total_flops
        assert abs(got - ref[arch]) / ref[arch] < COUNT_RTOL, \
            (arch, got, ref[arch])
    # head-TP prefill: the port's all-reduces over the 4 `model` shards
    _flags(monkeypatch, head_tp=True)
    cfg = replace(reduced_lm(get_arch("qwen2-1.5b").config),
                  vocab_size=VOCAB)
    sm = SH.shard_lm(T.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=meta), mesh)
    seen = []
    real = op_costs.CostCounter.record_collective

    def spy(self, op, nbytes, participants):
        seen.append((op, nbytes, participants))
        return real(self, op, nbytes, participants)
    monkeypatch.setattr(op_costs.CostCounter, "record_collective", spy)
    with CostCounter():
        lm_prefill_step(cfg, mesh)(sm, torch.empty(
            (2, 2048), dtype=torch.int32, device=meta))
    mine = [n for op, n, p in seen if op == "all-reduce" and p == 4]
    layer = [n for w, n in ref["prefill_all_reduces"] if w == "body"]
    entry = [n for w, n in ref["prefill_all_reduces"] if w == "entry"]
    act = 2048 * cfg.d_model * 4                # one group's (1, S, d) f32
    assert layer == [act, act] and entry == [act]
    assert mine == [act] * (1 + 2 * cfg.n_layers)
