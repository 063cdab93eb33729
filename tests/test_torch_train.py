"""The port's recsys training (``models/recsys.py``'s losses, the
train step, the async ``Checkpointer``, the ``Trainer`` and
``launch.train``) against the reference's, on the CPU at each smoke
config.

The reference's params (seed 0) are carried across with
``recsys_params_from_jax`` and both packages see the same numpy-made
batch (histories and bags with -1 pads). SASRec's loss takes the
reference's own negatives (its ``PRNGKey(0)`` draw, passed as
``neg_ids``). Matmuls, softmaxes and scatters round differently in XLA and
PyTorch, so each family's loss and every gradient are held to rtol 1e-5 /
atol 1e-6 (the serving tests' tolerance), and so are the parameters after
two steps of the train step with two microbatches on the two-tower model.
The int8 compression is checked on a loss whose gradients are exact in
both packages, at the optimizers' rtol 1e-6: on float gradients an ulp
of difference can round to the next int8 level, a step of 1/127 of the
block's largest value. The checkpointer and the Trainer are the port's
counterparts of ``tests/test_optim_ckpt.py``; a resumed run equals an
uninterrupted one bit for bit.
"""
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import recsys as jax_recsys
from repro.optim import mixed_optimizer as jax_mixed_optimizer
from repro.train.train_step import loss_fn_for as jax_loss_fn_for
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.carry import named_from_jax, optimizer_state_from_jax, \
    recsys_params_from_jax
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch, recsys_batch
from repro_torch.data.graph_sampler import graph_to_device, \
    make_dimenet_batch
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import dimenet, recsys, transformer
from repro_torch.optim import adamw, init_error_state, mixed_optimizer
from repro_torch.train.train_step import loss_fn_for, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["two-tower-retrieval", "sasrec", "din", "dlrm-mlperf"]
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


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **({"rtol": RTOL, "atol": ATOL} | tol))


def _np_batch(cfg, b, seed):
    """A training batch of ``cfg``'s family from numpy: ids per table at
    the config's bag sizes (multi-hot bags with -1 pads, row 0's bag all
    pads), dense features, histories with -1 pads (row 0 all pads but its
    last slot), their lengths, a target and 0/1 labels."""
    rng = np.random.default_rng(seed)
    hot = cfg.multi_hot or (1,) * cfg.n_sparse
    sparse = []
    for v, bag in zip(cfg.table_vocabs, hot):
        ids = rng.integers(0, v, (b, bag)).astype(np.int32)
        if bag > 1:
            ids[rng.random((b, bag)) < 0.25] = -1
            ids[0] = -1
            ids[1, :3] = ids[2, 0]             # repeated in and across bags
        sparse.append(ids)
    out = {"sparse_ids": sparse}
    if cfg.n_dense:
        out["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    if cfg.seq_len and cfg.interaction in ("self-attn-seq", "target-attn"):
        s = cfg.seq_len
        h = rng.integers(0, cfg.table_vocabs[0], (b, s)).astype(np.int32)
        h[rng.random((b, s)) < 0.2] = -1
        h[0, :-1] = -1
        out["history"] = h
        out["history_len"] = rng.integers(1, s + 1, b).astype(np.int32)
        out["target"] = rng.integers(0, cfg.table_vocabs[0], b).astype(
            np.int32)
    out["label"] = (rng.random(b) < 0.3).astype(np.float32)
    return out


def _tree(batch, fn):
    return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v)
            for k, v in batch.items()}


def _neg_ids(cfg):
    """The reference's SASRec negatives (its PRNGKey(0) draw)."""
    return np.array(jax.random.randint(jax.random.PRNGKey(0), (512,), 0,
                                       cfg.table_vocabs[0]))


@pytest.fixture(scope="module")
def families():
    """Per arch: its smoke config, the reference's params (seed 0), a
    numpy batch and the reference's loss and gradients on it."""
    out = {}
    for arch in ARCHS:
        cfg = jax_get_arch(arch).smoke_config
        params = jax_recsys.INIT[arch](jax.random.PRNGKey(0), cfg)
        batch = _np_batch(cfg, 16, seed=len(arch))
        jb = _tree(batch, jnp.asarray)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jax_recsys.LOSS[arch](p, cfg, b), has_aux=True))(
                params, jb)
        out[arch] = (cfg, params, batch, float(loss), grads)
    return out


def _port_grads(arch, cfg, params, batch):
    model = recsys_params_from_jax(params, cfg, device="cpu")
    tb = _tree(batch, torch.from_numpy)
    if arch == "sasrec":
        tb["neg_ids"] = torch.from_numpy(_neg_ids(cfg))
    loss, metrics = recsys.LOSS[arch](model, cfg, tb)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return model, loss, metrics, dict(zip(names, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(families, arch):
    cfg, params, batch, want_loss, want = families[arch]
    model, loss, metrics, got = _port_grads(arch, cfg, params, batch)
    _close(loss.item(), want_loss)
    assert metrics["loss"] is loss
    want = named_from_jax(want, CPU)
    assert set(got) == set(want)
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        _close(g, want[name], err_msg=name)
        assert torch.isfinite(g).all()
    assert got["table"].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_every_reference_leaf_is_a_trainable_parameter(families, arch):
    """Every weight trains: the port's trainable parameters are the
    reference's leaves, by name and shape (SASRec, DIN and DLRM once had
    frozen tables and blocks)."""
    cfg, params = families[arch][:2]
    model = recsys_params_from_jax(params, cfg, device="cpu")
    trainable = {n: tuple(p.shape) for n, p in model.named_parameters()
                 if p.requires_grad}
    leaves = {n: tuple(t.shape) for n, t in
              named_from_jax(params, CPU).items()}
    assert trainable == leaves
    fresh = recsys.INIT[arch](torch.Generator().manual_seed(0),
                              get_arch(arch).smoke_config)
    assert all(p.requires_grad for p in fresh.parameters())


def test_two_tower_bag_gradient_goes_through_the_bag_function(families):
    """The history bag's share of the table's gradient flows through the
    embedding_bag autograd function (the same one the card runs)."""
    cfg, params, batch = families["two-tower-retrieval"][:3]
    model = recsys_params_from_jax(params, cfg, device="cpu")
    u = model.user_embed(_tree(batch, torch.from_numpy))
    seen, todo = {}, [u.grad_fn]
    while todo:
        f = todo.pop()
        if f is not None and id(f) not in seen:
            seen[id(f)] = type(f).__name__
            todo.extend(n for n, _ in f.next_functions)
    assert "EmbeddingBagFunctionBackward" in seen.values()


def test_serving_builds_no_graph(families):
    """The serve steps run under inference_mode: trainable weights give no
    grad_fn and no gradient buffer."""
    from repro_torch.serve.serve_step import recsys_score_step
    for arch in ARCHS:
        cfg, params, batch = families[arch][:3]
        model = recsys_params_from_jax(params, cfg, device="cpu")
        out = recsys_score_step(cfg)(model, _tree(batch, torch.from_numpy))
        assert out.grad_fn is None and not out.requires_grad
        assert all(p.grad is None for p in model.parameters())


def test_in_batch_softmax_in_row_blocks_equals_one_block(monkeypatch):
    """The loss over blocks of rows (the full model's 17.2 GB logits never
    held at once) equals the one-block loss, value and gradients, to rtol
    1e-6 (the blocks' sums add in another order)."""
    from repro_torch.models import recsys_common
    g = torch.Generator().manual_seed(2)
    u = torch.randn((37, 16), generator=g, requires_grad=True)
    v = torch.randn((37, 16), generator=g, requires_grad=True)
    log_q = torch.rand((37,), generator=g)
    out = []
    for block_bytes in (1 << 31, 4 * 37 * 5):     # one block; blocks of 5
        monkeypatch.setattr(recsys_common, "LOSS_BLOCK_BYTES", block_bytes)
        loss = recsys_common.sampled_softmax_loss(u, v, log_q)
        out.append((loss, *torch.autograd.grad(loss, (u, v))))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    want = torch.nn.functional.cross_entropy(
        (u @ v.T) / 0.05 - log_q[None, :], torch.arange(37))
    torch.testing.assert_close(out[1][0], want, rtol=1e-6, atol=1e-7)


def test_sasrec_negatives_are_a_fixed_set():
    cfg = get_arch("sasrec").smoke_config
    a = recsys.sasrec_negatives(cfg, CPU)
    assert torch.equal(a, recsys.sasrec_negatives(cfg, CPU))
    assert a.shape == (512,) and int(a.min()) >= 0 \
        and int(a.max()) < cfg.table_vocabs[0]
    model = recsys.sasrec_init(torch.Generator().manual_seed(0), cfg)
    batch = recsys_batch(torch.Generator().manual_seed(1), 4, cfg)
    l0, _ = recsys.sasrec_loss(model, cfg, batch)
    l1, _ = recsys.sasrec_loss(model, cfg, batch, neg_ids=a)
    assert torch.equal(l0, l1)


def test_loss_fn_for_refuses_lm_and_gnn():
    """The GNN's loss is ported (tests/test_torch_dimenet.py): a finite
    loss on the launcher's graph batch; so is the LM's
    (tests/test_torch_transformer.py), its MoE configs too
    (tests/test_torch_moe.py): a finite loss with a positive aux. An
    unknown family raises KeyError."""
    cfg = get_arch("din").smoke_config
    gnn = get_arch("dimenet").smoke_config
    graph = graph_to_device(make_dimenet_batch(
        0, n_nodes=64, n_edges=128, n_triplets=512, n_graphs=4), "cpu")
    model = dimenet.init_params(torch.Generator().manual_seed(0), gnn)
    loss, met = loss_fn_for("gnn", gnn)(model, graph)
    assert torch.isfinite(loss) and met["loss"] is loss
    assert callable(loss_fn_for("lm", get_arch("qwen2-1.5b").smoke_config))
    moe = jax_get_arch("deepseek-moe-16b").smoke_config
    model = transformer.init_params(torch.Generator().manual_seed(0), moe)
    batch = lm_batch(torch.Generator().manual_seed(1), 2, 8, moe.vocab_size)
    loss, met = loss_fn_for("lm", moe)(model, batch)
    assert torch.isfinite(loss) and float(met["aux"]) > 0
    with pytest.raises(KeyError):
        loss_fn_for("ann", cfg)


# -- the train step --------------------------------------------------------

def test_train_step_with_microbatches_matches_the_reference(families):
    """Two microbatches and the mixed optimizer on the two-tower model
    (the bag's backward included), two steps: the parameters, the loss
    and the gradient norm against the reference's jitted step."""
    arch = "two-tower-retrieval"
    cfg, params = families[arch][:2]
    jopt = jax_mixed_optimizer(1e-3)
    jstep = jax.jit(jax_make_train_step(jax_loss_fn_for("recsys", cfg), jopt,
                                        microbatches=2))
    jp, js = params, jopt.init(params)
    model = recsys_params_from_jax(params, cfg, device="cpu")
    opt = mixed_optimizer(1e-3)
    step = make_train_step(loss_fn_for("recsys", cfg), opt, microbatches=2)
    state = opt.init(model)
    for s in range(2):
        b = _np_batch(cfg, 16, seed=100 + s)
        jp, js, jm = jstep(jp, js, _tree(b, jnp.asarray))
        model, state, m = step(model, state, _tree(b, torch.from_numpy))
        _close(m["loss"].item(), float(jm["loss"]))
        _close(m["grad_norm"].item(), float(jm["grad_norm"]))
        want = named_from_jax(jp, CPU)
        for name, p in model.named_parameters():
            _close(p.detach(), want[name], err_msg=name)
    assert int(state["step"]) == 2


def _quadratic(xp):
    """A loss whose gradients are exact in both packages: sum((p - mean of
    the batch's targets)^2) over a table and a dense leaf, on integers."""
    def loss(p, b):
        tab = p["table"] - b["t"].mean(0)
        w = p["mlp"]["w"] if xp is jnp else p["mlp.w"]
        dense = w - b["u"].mean(0)
        value = (tab * tab).sum() + (dense * dense).sum()
        return value, {"loss": value}
    return loss


def test_train_step_with_compression_matches_the_reference():
    """Two microbatches through the int8 error feedback and the mixed
    optimizer, against the reference's step: one step from a fresh
    state, and a third step from the reference's state after two
    (carried: params, optimizer and error state), at rtol 1e-6. The
    gradients are exact in both packages, so the quantizer sees the same
    bits (a gradient an ulp apart could round to the next int8 level)."""
    from repro.optim import init_error_state as jax_init_error_state
    rng = np.random.default_rng(7)
    p0 = {"table": rng.integers(-8, 9, (40, 16)).astype(np.float32),
          "mlp": {"w": rng.integers(-8, 9, (16, 5)).astype(np.float32)}}
    batches = [{"t": rng.integers(-8, 9, (4, 40, 16)).astype(np.float32),
                "u": rng.integers(-8, 9, (4, 16, 5)).astype(np.float32)}
               for _ in range(3)]
    jopt = jax_mixed_optimizer(1e-2)
    jstep = jax.jit(jax_make_train_step(_quadratic(jnp), jopt,
                                        microbatches=2, compress=True))
    opt = mixed_optimizer(1e-2)
    step = make_train_step(_quadratic(torch), opt, microbatches=2,
                           compress=True)

    jp = jax.tree.map(jnp.asarray, p0)
    js, je = jopt.init(jp), jax_init_error_state(jp)
    for i in range(3):
        if i in (0, 2):      # the port starts from the reference's state
            params = {n: t.requires_grad_() for n, t in
                      named_from_jax(jp, CPU).items()}
            state = optimizer_state_from_jax(js, CPU)
            err = named_from_jax(je, CPU)
        tb = {k: torch.from_numpy(v) for k, v in batches[i].items()}
        jp, js, je, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in
                                        batches[i].items()}, je)
        params, state, err, m = step(params, state, tb, err)
        if i in (0, 2):
            _close(m["loss"].item(), float(jm["loss"]), rtol=1e-6)
            for name, want in named_from_jax(jp, CPU).items():
                _close(params[name].detach(), want, rtol=1e-6,
                       err_msg=name)
            for name, want in named_from_jax(je, CPU).items():
                _close(err[name], want, rtol=1e-6, err_msg=name)
            acc = named_from_jax(js["leaves"], CPU)["table.acc"]
            _close(state["leaves"]["table"]["acc"], acc, rtol=1e-6)
    assert int(state["step"]) == 3


# -- the checkpointer ------------------------------------------------------

def _state(s=0.0):
    model = recsys.din_init(torch.Generator().manual_seed(0),
                            get_arch("din").smoke_config)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(s)
    return (model, {"a": torch.arange(6.0).reshape(2, 3) + s,
                    "b": {"c": torch.ones(4, dtype=torch.bfloat16) + s},
                    "lst": [torch.zeros(2), torch.full((3,), 7.0)],
                    "step": torch.tensor(int(s), dtype=torch.int32)})


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, _state(float(s)))
    ck.wait()
    assert ck.all_steps() == [2, 3]             # keep=2 gc'd step 1
    (model, tree), step = ck.restore(_state(0.0))
    assert step == 3
    want_model, want = _state(3.0)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              want_model.named_parameters()):
        assert torch.equal(p, q), n
        assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert torch.equal(tree["a"], want["a"])
    assert tree["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(tree["b"]["c"], want["b"]["c"])
    assert torch.equal(tree["lst"][1], want["lst"][1])
    assert tree["step"].dtype == torch.int32 and int(tree["step"]) == 3
    ck.close()


def test_save_copies_before_in_place_updates(tmp_path):
    ck = Checkpointer(str(tmp_path))
    x = torch.ones(3)
    ck.save(1, {"x": x})
    x.add_(5.0)                                 # the optimizer's next step
    ck.wait()
    restored, _ = ck.restore({"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.ones(3))
    ck.close()


def test_checkpoint_ignores_and_collects_partial_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(5, {"x": torch.ones(3)})
    ck.wait()
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crash mid-write
    assert ck.latest_step() == 5
    restored, _ = ck.restore({"x": torch.zeros(3)})
    assert torch.equal(restored["x"], torch.ones(3))
    ck.close()
    Checkpointer(str(tmp_path)).close()           # opening collects it
    assert not (tmp_path / "step_00000009.tmp").exists()


def test_restore_falls_back_past_a_corrupt_step(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    for s in (1, 2):
        ck.save(s, {"x": torch.full((64,), float(s))})
    ck.wait()
    npz = tmp_path / "step_00000002" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.warns(RuntimeWarning, match="skipping corrupt checkpoint"):
        restored, step = ck.restore({"x": torch.zeros(64)})
    assert step == 1 and torch.equal(restored["x"], torch.ones(64))
    with pytest.raises(ValueError):
        ck.restore({"x": torch.zeros(64)}, step=2)
    ck.close()


def test_close_refuses_later_saves_and_wait_raises_writer_errors(
        tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(2)})
    ck.wait()

    def full_disk(*args):
        raise OSError("no space left")

    monkeypatch.setattr(ck, "_write", full_disk)
    ck.save(2, {"x": torch.ones(2)})
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    ck.wait()                                   # one error, one wait
    ck.close()
    ck.close()
    assert not ck._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(3, {"x": torch.ones(2)})
    assert ck.all_steps() == [1]


# -- the trainer -----------------------------------------------------------

def _sasrec_trainer(tmpdir, total):
    cfg = get_arch("sasrec").smoke_config
    opt = mixed_optimizer(1e-2)
    step = make_train_step(loss_fn_for("recsys", cfg), opt)

    def step_fn(state, batch):
        model, o = state
        model, o, m = step(model, o, batch)
        return (model, o), m

    def batch_fn(s):                              # pure in the step
        return recsys_batch(torch.Generator().manual_seed(s), 8, cfg)

    tr = Trainer(step_fn, batch_fn, TrainerConfig(
        total_steps=total, ckpt_every=2, log_every=2, ckpt_dir=tmpdir))
    model = recsys.sasrec_init(torch.Generator().manual_seed(0), cfg)
    return tr, (model, opt.init(model))


def test_trainer_resume_bit_exact(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tr, state = _sasrec_trainer(d1, 6)
    final = tr.run(state)
    tr2, state2 = _sasrec_trainer(d2, 4)          # interrupted at step 4
    tr2.run(state2)
    tr3, fresh = _sasrec_trainer(d2, 6)
    state3, start = tr3.restore_or_init(fresh)
    assert start == 4
    resumed = tr3.run(state3, start_step=start)
    for (n, p), (_, q) in zip(final[0].named_parameters(),
                              resumed[0].named_parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(final[1]["leaves"]["table"]["acc"],
                       resumed[1]["leaves"]["table"]["acc"])
    assert int(resumed[1]["step"]) == 6
    assert tr.history[-1] == tr3.history[-1]
    for t in (tr, tr2, tr3):
        t.ckpt.close()


def test_trainer_straggler_detection(tmp_path):
    seen = []
    opt = adamw(0.05)
    step = make_train_step(lambda p, b: ((p["w"] ** 2).sum(),
                                         {"loss": (p["w"] ** 2).sum()}), opt)

    def step_fn(state, batch):
        params, o = state
        if int(batch[0]) == 9:                    # injected straggler
            time.sleep(0.25)
        params, o, m = step(params, o, batch)
        return (params, o), m

    cfg = TrainerConfig(total_steps=12, ckpt_every=100, log_every=100,
                        ckpt_dir=str(tmp_path), straggler_factor=3.0)
    tr = Trainer(step_fn, lambda s: torch.full((1,), s), cfg,
                 on_straggler=lambda s, f: seen.append((s, f)))
    params = {"w": torch.ones(2, requires_grad=True)}
    tr.run((params, opt.init(params)))
    tr.ckpt.close()
    assert any(s == 9 for s, _ in seen)
    assert 9 in tr.slow_steps


def test_optimizer_state_carries_across(families):
    """One reference step, its state carried to the port: the same
    leaves, names and step count."""
    cfg, params = families["din"][:2]
    jopt = jax_mixed_optimizer(1e-3)
    jstate = jopt.init(params)
    state = optimizer_state_from_jax(jstate, CPU)
    model = recsys_params_from_jax(params, cfg, device="cpu")
    want = mixed_optimizer(1e-3).init(model)
    assert set(state["leaves"]) == set(want["leaves"])
    for n, s in want["leaves"].items():
        assert {k: v.shape for k, v in s.items()} == \
            {k: v.shape for k, v in state["leaves"][n].items()}
    assert int(state["step"]) == 0


# -- the launcher ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_the_cpu(arch, capsys, tmp_path):
    train_main(["--arch", arch, "--steps", "4", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(re.escape(arch) + r": trained 4 steps; "
                        r"history=\[-?\d+\.\d+(, -?\d+\.\d+){3}\]", line), \
        line
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000004"]


def test_train_launcher_refuses_the_other_families(capsys):
    with pytest.raises(SystemExit, match="use launch/tune.py"):
        train_main(["--arch", "ann-laion", "--device", "cpu"])
    # the GNN trains (10.6c) and prints the reference's line; its serve
    # launcher exits with the reference's message
    capsys.readouterr()
    train_main(["--arch", "dimenet", "--steps", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(r"dimenet: trained 2 steps; history=\[\d+\.\d+"
                        r"(, \d+\.\d+)+\]", line), line
    with pytest.raises(SystemExit,
                       match=re.escape("gnn serving = scoring; use "
                                       "launch/train.py")):
        serve_main(["--arch", "dimenet", "--device", "cpu"])
    # the MoE LM is no longer refused (10.6b)
    train_main(["--arch", "deepseek-moe-16b", "--steps", "1", "--batch", "2",
                "--seq", "8", "--device", "cpu"])
