"""The port's dry-run records against the reference's rules: each record
is the port's own (its name and its ``package``), a train cell's link bytes
are its merges plus the reference's all-reduce of the weights' gradients,
and a recsys table's gradient and update are counted per device over
``model``.

The gradients' all-reduce is computed from the reference alone: its
parameter tree (``jax.eval_shape``), its ``family_rules`` and
``tree_shardings`` on an ``AbstractMesh`` of the production axis sizes,
and its ``analysis.hlo.parse_collectives`` wire factor, fed one HLO
all-reduce line per weight. A dense LM's train cell (qwen2-1.5b's
train_4k at full width, cut to LM_LAYERS layers: every term is linear in
the depth) adds its tensor-parallel collectives to that."""
import functools
import json
import math
import re
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.analysis.hlo import parse_collectives
from repro.distributed import sharding as RS
from repro.models import dimenet as r_dimenet
from repro.models import recsys as r_recsys
from repro.models import transformer as r_transformer

from repro_torch.analysis.op_costs import CostCounter
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.recsys_common import make_sharded_lookup, \
    padded_rows
from repro_torch.optim import mixed_optimizer
from repro_torch.train.train_step import loss_fn_for

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TRAIN_CELLS = [("sasrec", "train_batch"), ("dimenet", "molecule")]
_HLO_DTYPE = {np.dtype(np.float32): "f32", np.dtype(np.int32): "s32",
              np.dtype(jax.numpy.bfloat16): "bf16"}
LM_LAYERS = 2


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    shape = MESHES[name][0]
    return make_production_mesh(multi_pod=len(shape) == 3,
                                devices=[torch.device("meta")]
                                * math.prod(shape))


# ------------------------------------------------------------ ownership
def test_cli_leaves_a_reference_record_untouched(tmp_path):
    """A record under the reference's name in ``--out`` stays byte for
    byte; the port writes a fresh record of its own beside it."""
    ref_file = tmp_path / "dimenet__molecule__16x16.json"
    sentinel = b'{"status": "ok", "flops_per_device": -1.0}\n'
    ref_file.write_bytes(sentinel)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "dimenet", "--shape", "molecule", "--mesh",
                     "single", "--out", str(tmp_path)])
    assert e.value.code == 0
    assert ref_file.read_bytes() == sentinel
    own = tmp_path / "dimenet__molecule__16x16__torch.json"
    rec = json.loads(own.read_text())
    assert rec["package"] == "repro_torch" and rec["status"] == "ok"
    assert rec["flops_per_device"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [ref_file.name, own.name])


def test_run_cell_reuses_only_its_own_records(tmp_path):
    """Without ``--force`` a record at the port's name is returned only if
    it names the port's package; a file there that does not is run again
    and replaced. Skipped records name the package too."""
    path = dryrun.record_path(str(tmp_path), "dimenet", "molecule",
                              "16x16")
    with open(path, "w") as f:
        json.dump({"status": "ok", "flops_per_device": -1.0}, f)
    rec = dryrun.run_cell("dimenet", "molecule", False, str(tmp_path))
    assert rec["package"] == "repro_torch" and rec["flops_per_device"] > 0
    assert json.load(open(path)) == json.loads(json.dumps(rec,
                                                          default=str))
    mark = dict(rec, marker=1)
    with open(path, "w") as f:
        json.dump(mark, f)
    assert dryrun.run_cell("dimenet", "molecule", False,
                           str(tmp_path))["marker"] == 1
    assert "marker" not in dryrun.run_cell("dimenet", "molecule", False,
                                           str(tmp_path), force=True)
    skip = dryrun.run_cell("qwen3-32b", "long_500k", True, str(tmp_path))
    assert skip["status"] == "skipped" and skip["package"] == "repro_torch"
    assert json.load(open(dryrun.record_path(
        str(tmp_path), "qwen3-32b", "long_500k", "2x16x16")))[
            "package"] == "repro_torch"


# --------------------------------------------------------- link bytes
def _ref_params(arch, shape):
    spec = RC.get_arch(arch)
    key = jax.random.PRNGKey(0)
    if spec.family == "gnn":
        d_feat = spec.shape(shape).d_feat
        return jax.eval_shape(lambda: r_dimenet.init_params(
            key, spec.config, d_feat=d_feat))
    return jax.eval_shape(lambda: r_recsys.INIT[arch](key, spec.config))


def _ref_grad_allreduce(arch, shape, mesh_name) -> float:
    """The reference's per-device link bytes of the gradients' all-reduce:
    each leaf at its shard shape under its family rule, over the axes
    that split the step's work (recsys: the batch axes; gnn: every axis)
    that its spec leaves unsharded, priced by ``parse_collectives``."""
    dims, axes = MESHES[mesh_name]
    mesh = AbstractMesh(dims, axes)
    fam = RC.get_arch(arch).family
    return _allreduce_link_bytes(mesh, _ref_params(arch, shape), fam,
                                 RS.batch_axes(mesh) if fam == "recsys"
                                 else tuple(axes))


def _allreduce_link_bytes(mesh, tree, fam, work) -> float:
    """``parse_collectives``' link bytes of one all-reduce per leaf of
    ``tree`` at its shard shape under ``fam``'s rules, over the axes of
    ``work`` its spec leaves unsharded."""
    dims = tuple(mesh.shape.values())
    shardings = RS.tree_shardings(mesh, tree, RS.family_rules(fam, mesh))
    lines = []
    for i, (leaf, sh) in enumerate(zip(jax.tree.leaves(tree),
                                       jax.tree.leaves(shardings))):
        used = {a for e in sh.spec if e is not None
                for a in (e if isinstance(e, tuple) else (e,))}
        part = math.prod(mesh.shape[a] for a in work if a not in used)
        shard = ",".join(str(d) for d in sh.shard_shape(leaf.shape))
        lines.append(f"%ar.{i} = {_HLO_DTYPE[np.dtype(leaf.dtype)]}[{shard}]"
                     f" all-reduce(%g.{i}), replica_groups="
                     f"[{math.prod(dims) // part},{part}]")
    return parse_collectives("\n".join(lines)).link_bytes


@functools.lru_cache(maxsize=None)
def _counted(arch, shape, mesh_name):
    """(the record, the link bytes of the loss and its gradients alone:
    the step's merges, the counter of the step)."""
    mesh = _mesh(mesh_name)
    cell = S.build_cell(arch, shape, mesh, device="meta")
    run = dryrun.count_cell(cell)
    rec = dryrun.cell_record(cell, mesh, mesh_name, run)
    model, _, batch = cell.args
    cfg = get_arch(arch).config
    if get_arch(arch).family == "gnn":
        loss_fn = S.make_gnn_loss(cfg, mesh)
    else:
        loss_fn = loss_fn_for("recsys", cfg, lookup_fn=make_sharded_lookup(
            mesh, padded_rows(cfg.table_vocabs)))
    merges = CostCounter(outside_split=cell.outside_split)
    for t, n in cell.row_split:
        merges.place(t, n)
    with merges:
        out = loss_fn(model, batch)
        loss = out[0] if isinstance(out, tuple) else out
        torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True)
    return rec, merges.per_device().link_bytes, run["counter"]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", TRAIN_CELLS)
def test_train_link_bytes_are_merges_plus_gradient_allreduce(
        arch, shape, mesh_name):
    """``link_bytes_per_device`` is the step's merges plus the reference's
    all-reduce of every weight's gradient (rtol 1e-9), and the record
    counts one all-reduce per weight that has one besides the merges'."""
    rec, merges, _ = _counted(arch, shape, mesh_name)
    grads = _ref_grad_allreduce(arch, shape, mesh_name)
    assert grads > 0 and merges > 0
    assert rec["link_bytes_per_device"] == pytest.approx(merges + grads,
                                                         rel=1e-9)
    n_leaves = len(jax.tree.leaves(_ref_params(arch, shape)))
    merged = 1 if arch == "dimenet" else 3     # shard_sum; 3 lookups
    assert rec["collective_counts"]["all-reduce"] == merged + n_leaves
    assert rec["partition"] == "shards" and "all-reduced" in rec["notes"]


def test_lookup_merges_follow_the_group_batch():
    """SASRec's lookups merge each batch group's rows over ``model``: per
    device, the (2, 16, 16) mesh's groups hold half the (16, 16) mesh's
    rows, so half the merge bytes (the same 16 shards)."""
    one = _counted("sasrec", "train_batch", "16x16")[1]
    two = _counted("sasrec", "train_batch", "2x16x16")[1]
    assert two == pytest.approx(one / 2, rel=1e-12)


# -------------------------------------------------------- table bytes
def test_table_work_is_split_over_model():
    """The table's gradient assembly and its update sit in the one bucket
    over ``model`` (16 devices) on both meshes, with the same bytes; per
    device the record adds them divided by 16, beside the busiest shard
    and the batch work over the data axes."""
    per = {}
    for mesh_name in MESHES:
        rec, _, c = _counted("sasrec", "train_batch", mesh_name)
        assert set(c.splits) == {1, 16}     # 1: the gradients' all-reduce
        assert c.splits[1].bytes == 0 and c.splits[16].bytes > 0
        assert c.splits[16].op_counts["sub_"] > 0        # the update
        dp = 16 if mesh_name == "16x16" else 32
        want = c.busiest_shard().bytes + c.common.bytes / dp \
            + c.splits[16].bytes / 16
        assert rec["bytes_per_device"] == pytest.approx(want, rel=1e-12)
        per[mesh_name] = c.splits[16].bytes
    assert per["16x16"] == per["2x16x16"]


def test_table_update_bytes_per_device_are_over_model():
    """The row-wise Adagrad update of SASRec's table (and the clip's sum
    over its gradient), counted alone: with the table, its accumulator
    and its gradient placed over 16 devices, the bytes per device and the
    peak are the whole update's over 16 (the scalars' few bytes aside)."""
    cfg = get_arch("sasrec").config
    table = torch.empty((padded_rows(cfg.table_vocabs), cfg.embed_dim),
                        device="meta")
    opt = mixed_optimizer(1e-3)

    def count(n):
        params = {"table": table}
        state = opt.init(params)
        grads = {"table": torch.empty_like(table)}
        c = CostCounter()
        if n:
            for t in (table, state["leaves"]["table"]["acc"],
                      grads["table"]):
                c.place(t, n)
        with c:
            opt.update(grads, state, params)
        return c

    whole, split = count(0), count(16)
    assert split.splits[16].bytes + split.common.bytes == whole.common.bytes
    assert split.common.bytes < 1e-6 * whole.common.bytes
    assert split.per_device().bytes == pytest.approx(
        whole.per_device().bytes / 16, rel=1e-6)
    assert split.peak_bytes == pytest.approx(whole.peak_bytes / 16,
                                             rel=1e-6)
    assert whole.common.bytes > 2 * table.numel() * 4


# ---------------------------------------------------- the dense LMs
@functools.lru_cache(maxsize=None)
def _lm_counted(mesh_name, arch="qwen2-1.5b"):
    """``arch``'s train_4k cell cut to LM_LAYERS layers: (the record, the
    link bytes and all-reduces of its loss and gradients alone over the
    step's microbatches, the cell, the reference config)."""
    spec = get_arch(arch)
    spec = replace(spec, config=replace(spec.config, n_layers=LM_LAYERS))
    mesh = _mesh(mesh_name)
    cell = S._lm_cell(spec, spec.shape("train_4k"), mesh, "meta", 0)
    rec = dryrun.cell_record(cell, mesh, mesh_name, dryrun.count_cell(cell))
    model, _, batch = cell.args
    micro = int(re.search(r"microbatches=(\d+)", cell.notes).group(1))
    rows = batch["tokens"].shape[0] // micro
    merges = CostCounter(outside_split=cell.outside_split)
    with merges:
        loss, _ = transformer.lm_loss(model, spec.config,
                                      {k: v[:rows] for k, v in batch.items()},
                                      mesh=mesh)
        torch.autograd.grad(loss, list(model.parameters()),
                            allow_unused=True)
    ref_cfg = replace(RC.get_arch(arch).config, n_layers=LM_LAYERS)
    return rec, micro * merges.per_device().link_bytes, \
        merges.per_device().collective_counts["all-reduce"], cell, ref_cfg


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_lm_train_link_bytes_are_tp_collectives_plus_gradient_allreduce(
        mesh_name, arch):
    """An LM's train record (``"partition": "shards"``; deepseek-moe-16b's
    2 layers are its dense block and an MoE block): its link bytes are
    its tensor- and expert-parallel collectives (the loss and gradients
    of each microbatch: the lookup's and the row-parallel all-reduces,
    the attention's all-to-alls and K / V gathers, the fan-outs' backward
    all-reduces, the head's gather; the MoE layer's combine and its aux
    loss's all-reduces over the data axes) plus the reference's
    all-reduce of every weight's gradient over the data axes (rtol 1e-9);
    its all-reduces are those of the programs plus one per leaf a device
    holds; its notes name that all-reduce."""
    rec, tp_bytes, tp_reduces, cell, ref_cfg = _lm_counted(mesh_name, arch)
    dims, axes = MESHES[mesh_name]
    mesh = AbstractMesh(dims, axes)
    tree = jax.eval_shape(lambda: r_transformer.init_params(
        jax.random.PRNGKey(0), ref_cfg))
    grads = _allreduce_link_bytes(mesh, tree, "lm", RS.batch_axes(mesh))
    assert tp_bytes > 0 and grads > 0
    assert rec["link_bytes_per_device"] == pytest.approx(tp_bytes + grads,
                                                         rel=1e-9)
    model = cell.args[0]
    assert rec["collective_counts"]["all-reduce"] == \
        tp_reduces + len(model.device_names())
    assert {"all-gather", "all-to-all", "reduce-scatter"} <= \
        set(rec["collective_counts"])
    assert rec["partition"] == "shards" and rec["collective_s"] > 0
    assert "all-reduced" in rec["notes"] and "ideal" not in rec["notes"]
