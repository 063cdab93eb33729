"""The MoE and MLA configs' tensor- and expert-parallel programs
(``sharding.shard_lm`` on deepseek-moe-16b and deepseek-v2-236b,
``moe.moe_apply_tp``, ``layers.mla_apply_tp`` / ``mla_decode_tp``, the
leading dense block's splits) against the unsharded port and the
reference on carried weights, on the CPU: meshes (1, 2), (2, 2) and (1, 4)
naming the CPU once per device, ``HEAD_TP_ATTENTION`` on and off; and the
count of a meta (2, 4) mesh beside the reference's step partitioned by XLA
over 8 forced host devices.

The models are the reduced configs (4 heads, 2 layers: one dense block and
one MoE block of 8 experts, top-2) with a vocabulary of 512 on both sides
(the reduced 503 is prime: the rules' guard would replicate ``embed`` and
the head), in dispatch groups of 16 tokens at capacity factor 1.0: a batch
of 4 x 12 is 3 groups of capacity 5, and pairs drop. On (2, 2) each batch
group's 24 tokens hold one group and half of the next, so the middle group
spans both batch groups (the exclusive scan over the data axes); a decode
step's one dispatch group spans them too. Tolerances are the ground
rules': logits, aux and losses rtol 1e-5 / atol 1e-6 of the compared
tensor's scale, gradients and one AdamW step rtol 1e-5 / atol GRAD_ATOL of
each leaf's scale, as ``tests/test_torch_tensor_parallel.py``; the routed
ids and the dropped pairs are bit-equal."""
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

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import reduced_lm as jax_reduced_lm
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro_torch import flags
from repro_torch.analysis import op_costs
from repro_torch.analysis.op_costs import CostCounter
from repro_torch.carry import lm_named_from_jax, lm_params_from_jax
from repro_torch.configs import get_arch, reduced_lm
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step
from repro_torch.train.train_step import loss_fn_for, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 3e-6
CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2), (1, 4)]
ARCHS = ["deepseek-moe-16b", "deepseek-v2-236b"]
VOCAB = 512
B, S = 4, 12
SHAPE = dict(vocab_size=VOCAB, moe_group_size=16, moe_capacity_factor=1.0)
# the port's per-device FLOPs of the reduced train step (4 x 64) on a meta
# (2, 4) mesh over the unsharded port's count of the same step over the 8
# devices: 1.278 (deepseek-moe-16b) and 1.343 (deepseek-v2-236b) measured
# (replicated work: the router, the norms, the leading dense block's
# projections and gate, the MLA down-projections, large beside d = 64);
# held to [1, 1.5]. XLA's partition counts 114.5M and 120.2M by hlo_costs
# against the port's 104.1M and 112.1M, its MoE FLOPs the one-hot
# dispatch products that the port's gathers replace.
FLOPS_OVER_IDEAL = (1.0, 1.5)
# the port's per-device link bytes over XLA's on that step: 0.827 and
# 0.857 measured (XLA gathers weights where the port moves activations,
# PERF.md); held to [0.5, 2]
LINK_OVER_XLA = (0.5, 2.0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _collectives_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tp_collectives", os.path.join(REPO, "tests", "tp_collectives.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TPC = _collectives_script()
COUNT_CELLS = [("train 4 x 64", arch, "train", 4, 64, False)
               for arch in ARCHS]
_COUNT: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _reference_count():
    """XLA's partition of the reduced train steps (``tp_collectives.py``'s
    script), started in a process of its own as the module begins."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", TPC._REFERENCE, json.dumps(COUNT_CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    _COUNT["proc"] = proc
    yield
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


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
    """Per arch: its config, the reference's perturbed params, the port's
    model over the same weights, and a numpy batch (B x S)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_reduced_lm(jax_get_arch(arch).config, **SHAPE)
        jp = _perturbed(JT.init_params(jax.random.PRNGKey(0), cfg), 50 + i)
        tokens = np.random.default_rng(60 + i).integers(
            0, VOCAB, (B, S)).astype(np.int32)
        out[arch] = dict(cfg=cfg, jp=jp,
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
    return {name: tensors[f"shards.0.{name}"] if d is None else
            torch.cat([tensors[f"shards.{s}.{name}"] for s in range(n)],
                      dim=d) for name, d in sm.dims.items()}


def _ref_kept(idx, g, e, cap):
    """The reference's keep mask (moe.py:84-89) from its own ids."""
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(g, -1, idx.shape[-1]),
                            e, dtype=jnp.int32)
    flat = onehot.reshape(g, -1, e)
    pos = (jnp.cumsum(flat, axis=1) - 1).reshape(onehot.shape)
    return np.asarray(jnp.sum(pos * onehot, axis=-1) < cap).reshape(
        idx.shape)


_REF: dict = {}


def _reference(m, arch):
    """The reference's forward (logits, aux, each MoE layer's routed ids,
    recorded from its router by a debug callback), its loss and
    gradients, once per arch."""
    if arch not in _REF:
        seen = []
        real = JM._route

        def spy(logits, top_k):
            w, idx, aux = real(logits, top_k)
            jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx)
            return w, idx, aux
        JM._route = spy
        try:
            logits, aux = JT.forward(m["jp"], m["cfg"],
                                     jnp.asarray(m["tokens"]), remat=False)
            jax.effects_barrier()
        finally:
            JM._route = real
        cfg = m["cfg"]
        (loss, met), g = jax.jit(jax.value_and_grad(
            lambda p, b: JT.lm_loss(p, cfg, b), has_aux=True))(
            m["jp"], _batch(m, False))
        _REF[arch] = dict(logits=np.asarray(logits), aux=float(aux),
                          ids=seen, loss=float(loss), grads=g,
                          named=lm_named_from_jax(g, CPU))
    return _REF[arch]


_PORT: dict = {}


def _port(m, arch):
    """The unsharded port's forward (logits, aux, routing log) and its
    loss and gradients, once per arch."""
    if arch not in _PORT:
        with torch.no_grad(), M.routing_log() as log:
            logits, aux = T.forward(m["model"], m["cfg"],
                                    torch.from_numpy(m["tokens"]))
        ps = dict(m["model"].named_parameters())
        loss, met = T.lm_loss(m["model"], m["cfg"], _batch(m))
        _PORT[arch] = dict(logits=logits, aux=float(aux), log=log,
                           loss=float(loss), nll=float(met["loss"]),
                           grads=dict(zip(
                               ps, torch.autograd.grad(loss, list(
                                   ps.values())))))
    return _PORT[arch]


def _same_routing(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a["ids"], b["ids"])
        assert torch.equal(a["dropped"], b["dropped"])
        assert int(a["kept"]) == int(b["kept"])
        assert torch.equal(a["counts"], b["counts"])
        assert (a["pairs"], a["slots"]) == (b["pairs"], b["slots"])


# ------------------------------------------------------- the weights
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_lm_takes_the_moe_and_mla_configs(models, arch):
    """The leading dense block runs the reference's splits (its ``wo`` and
    ``w_down`` on their output columns, the rest replicated), the MoE
    block's routed experts split on their expert axis, the shared experts
    column- then row-parallel, the router replicated, MLA's ``wq_b`` /
    ``wkv_b`` column-split and ``wo`` row-split; shards are views, and
    ``unshard_lm`` gives the model back bit for bit."""
    m = models[arch]
    model, mesh = m["model"], _mesh((1, 4))
    sm = SH.shard_lm(model, mesh)
    d = sm.dims
    a0, a1 = "blocks.0.attn.", "blocks.1.attn."
    assert d[a0 + "wo"] == 1 and d["blocks.0.ffn.w_down"] == 1
    assert d["blocks.0.ffn.w_gate"] is None and d["blocks.0.ffn.w_up"] is None
    assert d["blocks.1.moe.w_gate"] == d["blocks.1.moe.w_down"] == 0
    assert d["blocks.1.moe.shared.w_up"] == 1
    assert d["blocks.1.moe.shared.w_down"] == 0
    assert d["blocks.1.moe.router"] is None and d[a1 + "wo"] == 0
    if m["cfg"].use_mla:
        for w in ("wq_a", "wq_b", "wkv_a", "wkv_b", "kv_a_norm"):
            assert d[a0 + w] is None
        assert d[a1 + "wq_b"] == d[a1 + "wkv_b"] == 1
        assert d[a1 + "wq_a"] is None and d[a1 + "wkv_a"] is None
    else:
        assert all(d[a0 + w] is None for w in ("wq", "wk", "wv"))
        assert all(d[a1 + w] == 1 for w in ("wq", "wk", "wv"))
    params = dict(model.named_parameters())
    e = m["cfg"].n_routed_experts
    for s, shard in enumerate(sm.shards):
        mine = dict(shard.named_parameters())
        w = mine["blocks.1.moe.w_gate"]
        assert w.shape[0] == e // 4
        assert torch.equal(w, params["blocks.1.moe.w_gate"][s * 2:s * 2 + 2])
        assert w.untyped_storage().data_ptr() == \
            params["blocks.1.moe.w_gate"].untyped_storage().data_ptr()
    back = dict(SH.unshard_lm(sm).named_parameters())
    assert all(torch.equal(back[n], p) for n, p in params.items())


# ------------------------------------------------ forward, loss, grads
@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_aux_and_routing(models, arch, shape, head_tp,
                                        monkeypatch):
    """Logits and the aux loss against the unsharded port and the
    reference; the routed ids, the per-expert counts and the dropped
    pairs equal the unsharded port's, and the ids and drops equal the
    reference's (pairs do drop)."""
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", head_tp)
    m = models[arch]
    cfg, mesh = m["cfg"], _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    with torch.no_grad(), M.routing_log() as log:
        got, aux = T.forward(sm, cfg, torch.from_numpy(m["tokens"]),
                             mesh=mesh)
    port, ref = _port(m, arch), _reference(m, arch)
    assert got.shape == (B, S, VOCAB)
    _close(got, port["logits"])
    _close(got, ref["logits"])
    _close(float(aux), port["aux"])
    _close(float(aux), ref["aux"])
    _same_routing(log, port["log"])
    g, _, cap = M.groups_and_capacity(cfg, B * S)
    assert (g, cap) == (3, 5)
    for entry, ids in zip(log, ref["ids"]):
        assert np.array_equal(entry["ids"].numpy(), ids)
        kept = _ref_kept(ids, g, cfg.n_routed_experts, cap)
        assert np.array_equal(~entry["dropped"].numpy(), kept)
        assert 0 < int(entry["dropped"].sum()) < kept.size


@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients(models, arch, shape, head_tp, monkeypatch):
    """The loss (aux included) against the reference's; every leaf's
    gradient (the shards' joined) against the unsharded port's, and
    against ``jax.value_and_grad`` of the reference within GRAD_ATOL of
    the leaf's scale or twice the unsharded port's own distance to it,
    whichever is larger (as the dense LMs' test)."""
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", head_tp)
    m = models[arch]
    mesh = _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    loss, met = T.lm_loss(sm, m["cfg"], _batch(m), mesh=mesh)
    ps = dict(sm.named_parameters())
    grads = torch.autograd.grad(loss, list(ps.values()))
    ref, port = _reference(m, arch), _port(m, arch)
    _close(loss.detach(), ref["loss"])
    _close(loss.detach(), port["loss"])
    _close(met["aux"].detach(), ref["aux"])
    got = _joined(sm, dict(zip(ps, grads)))
    assert got.keys() == ref["named"].keys() == port["grads"].keys()
    for n, g in got.items():
        _close(g, port["grads"][n], atol=GRAD_ATOL, err_msg=n)
        w = ref["named"][n].numpy()
        own = float(np.abs(port["grads"][n].numpy() - w).max())
        limit = max(GRAD_ATOL * float(np.abs(w).max()), 2 * own)
        assert float(np.abs(g.numpy() - w).max()) <= limit, n
    assert float(got["blocks.1.moe.router"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_on_the_reference_gradients(models, arch):
    """AdamW over a ``ShardedLM``'s leaves (experts split on their expert
    axis), fed the reference's gradients cut into shards, equals the
    reference's step on every leaf and moment; and ``make_train_step``
    with the mesh hands the optimizer the unsharded step's gradients."""
    m = models[arch]
    mesh = _mesh((2, 2))
    model = lm_params_from_jax(m["jp"], m["cfg"], CPU)
    sm = SH.shard_lm(model, mesh)
    ref = _reference(m, arch)
    jopt, opt = jax_adamw(3e-4), adamw(3e-4)
    jnew, jstate, jmet = jax.jit(jopt.update)(
        ref["grads"], jopt.init(m["jp"]), m["jp"])
    grads = {}
    for pn, p in sm.named_parameters():
        s, name = int(pn.split(".")[1]), pn.split(".", 2)[2]
        d, g = sm.dims[name], ref["named"][name]
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
    seen = {}

    def capture(grads, state, params):
        seen.update({k: v.clone() for k, v in grads.items()})
        return params, state, {}
    from repro_torch.optim import Optimizer
    step = make_train_step(loss_fn_for("lm", m["cfg"], mesh=mesh),
                           Optimizer(lambda p: {}, capture), mesh=mesh)
    _, _, out = step(SH.shard_lm(m["model"], mesh), {}, _batch(m))
    port = _port(m, arch)
    _close(out["loss"], port["nll"])
    joined = _joined(SH.shard_lm(m["model"], mesh), seen)
    for n, g in port["grads"].items():
        _close(joined[n], g, atol=GRAD_ATOL, err_msg=n)


# ------------------------------------------------ prefill and decode
_SERVED: dict = {}
# the reference's serving entry points, compiled once per config
_jprefill = jax.jit(JT.prefill, static_argnums=(1, 3))
_jdecode = jax.jit(JT.decode_step, static_argnums=1)


def _served(m, arch):
    """The reference's and the unsharded port's prefill of 8 tokens into a
    16-slot cache and 4 decode steps of the reference's greedy ids: (ids,
    the reference's logits, the port's logits, the port's cache and its
    decode steps' routing), once per arch."""
    if arch not in _SERVED:
        cfg = m["cfg"]
        prompt = m["tokens"][:, :8]
        mine, mc = T.prefill(m["model"], cfg, torch.from_numpy(prompt),
                             max_len=16)
        want, jc = _jprefill(m["jp"], cfg, jnp.asarray(prompt), 16)
        ids, refs, ports = [], [np.asarray(want)], [mine]
        with M.routing_log() as log:
            for step in range(4):
                tok = refs[-1][:, -1] if step == 0 else refs[-1]
                ids.append(np.asarray(tok).argmax(-1).astype(np.int32))
                pos = np.full((B,), 8 + step, np.int32)
                mine, mc = T.decode_step(m["model"], cfg,
                                         torch.from_numpy(ids[-1]), mc,
                                         torch.from_numpy(pos))
                want, jc = _jdecode(m["jp"], cfg, jnp.asarray(ids[-1]), jc,
                                    jnp.asarray(pos))
                refs.append(np.asarray(want))
                ports.append(mine)
        _SERVED[arch] = (ids, refs, ports, mc, log)
    return _SERVED[arch]


@pytest.mark.parametrize("head_tp", [False, True])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(models, arch, shape, head_tp, monkeypatch):
    """Prefill 8 tokens into a 16-slot cache, then 4 decode steps of the
    reference's greedy ids: each step's logits equal the unsharded port's
    and the reference's, and its routing the unsharded port's (on (2, 2)
    a step's one dispatch group of 4 tokens spans both batch groups). The
    GQA cache splits on KV heads (4 divide ``model``), the MLA latent
    cache on sequence, each holding the unsharded cache's entries."""
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", head_tp)
    m = models[arch]
    cfg, mesh = m["cfg"], _mesh(shape)
    sm = SH.shard_lm(m["model"], mesh)
    ids, refs, ports, mc, plog = _served(m, arch)
    got, cache = T.prefill(sm, cfg, torch.from_numpy(m["tokens"][:, :8]),
                           max_len=16, mesh=mesh)
    split = SH.cache_split(cfg, mesh)
    assert split == ("seq" if cfg.use_mla else "heads")
    _close(got, ports[0])
    _close(got, refs[0])
    with M.routing_log() as log:
        for step in range(4):
            pos = np.full((B,), 8 + step, np.int32)
            got, cache = T.decode_step(sm, cfg, torch.from_numpy(ids[step]),
                                       cache, torch.from_numpy(pos),
                                       mesh=mesh)
            _close(got, ports[step + 1])
            _close(got, refs[step + 1])
    _same_routing(log, plog)
    assert np.array_equal(cache.length.numpy(), mc.length.numpy())
    for i, which in enumerate(("a", "b")):
        rows = [torch.cat([blk[i] for blk in group],
                          dim=3 if split == "heads" else 2)
                for group in cache.blocks]
        _close(torch.cat(rows, dim=1), getattr(mc, which))
    assert len(cache.blocks) == shape[0]


@pytest.mark.parametrize("rows", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_dispatch_group_spans_the_batch_groups(models, arch, rows):
    """A decode step on (2, 2): its rows are one dispatch group split over
    both batch groups. 2 rows: one token a batch group, the second's
    positions counted after the first's pairs. 4 rows routed to given ids
    (``forced_routing``) so that expert 0 takes 3 pairs at capacity 2: the
    third, in the second batch group, drops only through the exclusive
    scan. Logits, ids and drops equal the unsharded step's."""
    m = models[arch]
    cfg, mesh = m["cfg"], _mesh((2, 2))
    sm = SH.shard_lm(m["model"], mesh)
    prompt = torch.from_numpy(m["tokens"][:rows, :8])
    _, plain = T.prefill(m["model"], cfg, prompt, max_len=16)
    _, cache = T.prefill(sm, cfg, prompt, max_len=16, mesh=mesh)
    tok = torch.from_numpy(m["labels"][:rows, 7].copy())
    pos = torch.full((rows,), 8, dtype=torch.int32)
    forced = [torch.tensor([[0, 1], [0, 2], [0, 3], [1, 2]])] \
        if rows == 4 else None
    assert M.groups_and_capacity(cfg, rows)[::2] == (1, 2)
    runs = []
    for model, c, on in ((m["model"], plain, None), (sm, cache, mesh)):
        with M.routing_log() as log:
            if forced is None:
                out, _ = T.decode_step(model, cfg, tok, c, pos, mesh=on)
            else:
                with M.forced_routing(forced):
                    out, _ = T.decode_step(model, cfg, tok, c, pos, mesh=on)
        runs.append((out, log))
    _close(runs[1][0], runs[0][0])
    _same_routing(runs[1][1], runs[0][1])
    dropped = runs[1][1][0]["dropped"]
    if forced is not None:
        assert dropped.tolist() == [[False, False], [False, False],
                                    [True, False], [False, False]]


def test_serve_steps_take_the_moe_configs(models, monkeypatch):
    """``lm_prefill_step`` and ``lm_decode_step`` with a mesh give the
    unsharded steps' logits for both configs."""
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", False)
    for arch in ARCHS:
        m = models[arch]
        cfg, mesh = m["cfg"], _mesh((2, 2))
        sm = SH.shard_lm(m["model"], mesh)
        tokens = torch.from_numpy(m["tokens"][:, :8])
        got, cache = lm_prefill_step(cfg, mesh)(sm, tokens)
        want, wc = lm_prefill_step(cfg)(m["model"], tokens)
        _close(got, want)
        tok = want.argmax(-1).int()
        pos = torch.full((B,), 7, dtype=torch.int32)
        got, _ = lm_decode_step(cfg, mesh)(sm, tok, cache, pos)
        want, _ = lm_decode_step(cfg)(m["model"], tok, wc, pos)
        _close(got, want)


# ------------------------------------ the count against XLA's partition
def test_meta_count_beside_the_reference_partition(monkeypatch):
    """On a meta (2, 4) mesh, each reduced config's train step (4 x 64,
    default flags): per-device FLOPs within FLOPS_OVER_IDEAL of the
    unsharded port's count over the 8 devices, link bytes > 0 and within
    LINK_OVER_XLA of XLA's partition of the reference's step over 8
    forced host devices, the collectives all-reduce, all-gather,
    all-to-all and reduce-scatter; the aux loss's two (E,) all-reduces
    over the data axes priced. A decode step of 2 rows (one dispatch group
    over both batch groups) prices the exclusive scan: an all-gather of
    each group's (1, E) counts over the 2 of them."""
    out, err = _COUNT["proc"].communicate(timeout=600)
    assert _COUNT["proc"].returncode == 0, err[-3000:]
    ref = json.loads(out)
    monkeypatch.setattr(flags, "HEAD_TP_ATTENTION", False)
    meta = torch.device("meta")
    mesh = make_host_mesh(2, 4, devices=[meta] * 8)
    seen = []
    real = op_costs.CostCounter.record_collective

    def spy(self, op, nbytes, participants):
        seen.append((op, nbytes, participants))
        return real(self, op, nbytes, participants)
    monkeypatch.setattr(op_costs.CostCounter, "record_collective", spy)
    for arch, r in zip(ARCHS, ref):
        cfg = replace(reduced_lm(get_arch(arch).config), vocab_size=VOCAB)
        model = T.init_params(torch.Generator().manual_seed(0), cfg,
                              device=meta)
        t = torch.empty((4, 64), dtype=torch.int32, device=meta)
        batch = {"tokens": t, "labels": t}
        opt = adamw(3e-4)
        with CostCounter() as c:
            make_train_step(loss_fn_for("lm", cfg), opt)(
                model, opt.init(model), batch)
        ideal = c.per_device().total_flops / 8
        sm = SH.shard_lm(model, mesh)
        seen.clear()
        with CostCounter() as c:
            make_train_step(loss_fn_for("lm", cfg, mesh=mesh), opt,
                            mesh=mesh)(sm, opt.init(sm), batch)
        d = c.per_device()
        lo, hi = FLOPS_OVER_IDEAL
        assert lo <= d.total_flops / ideal <= hi, (arch, d.total_flops,
                                                   ideal)
        lo, hi = LINK_OVER_XLA
        assert d.link_bytes > 0 and r["link_bytes"] > 0
        assert lo <= d.link_bytes / r["link_bytes"] <= hi, (
            arch, d.link_bytes, r["link_bytes"])
        assert set(d.collective_counts) == {"all-reduce", "all-gather",
                                            "all-to-all", "reduce-scatter"}
        assert {"all-reduce", "all-gather"} <= set(r["counts"])
        e = cfg.n_routed_experts
        assert ("all-reduce", 8 * e, 2) in seen          # the pair counts
        assert ("all-reduce", 4 * e, 2) in seen          # the prob sums
        seen.clear()
        ids = torch.empty((2,), dtype=torch.int32, device=meta)
        cache = SH.init_sharded_cache(cfg, mesh, 2, 64, torch.float32)
        with CostCounter():
            lm_decode_step(cfg, mesh)(sm, ids, cache, ids)
        assert ("all-gather", 2 * 8 * e, 2) in seen
