"""The port's sharding rules, cell list and search input specs against the
reference's, on the production meshes (``jax.sharding.AbstractMesh``: no
devices needed on either side; the port's parameters on ``meta``).

Per-device bytes are compared leaf by leaf: a port LM layer is one slice
of the reference's stacked leaf, so the L slices' bytes must sum to the
stacked leaf's."""
import math
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.distributed import sharding as RS
from repro.models import dimenet as r_dimenet
from repro.models import recsys as r_recsys
from repro.models import transformer as r_transformer

from repro_torch import flags
from repro_torch.carry import lm_reference_path, reference_path
from repro_torch.configs import get_arch, iter_cells
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch import specs as S
from repro_torch.models import dimenet, recsys, transformer

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LM_ARCHS = ("qwen3-32b", "qwen2-1.5b", "mistral-nemo-12b",
            "deepseek-v2-236b", "deepseek-moe-16b")
RECSYS_ARCHS = ("sasrec", "two-tower-retrieval", "dlrm-mlperf", "din")


def _meshes(name):
    shape, axes = MESHES[name]
    ref = AbstractMesh(shape, axes)
    port = make_production_mesh(multi_pod=len(shape) == 3,
                                devices=[torch.device("meta")]
                                * math.prod(shape))
    return ref, port


def _ref_leaf_bytes(tree, shardings) -> dict:
    out = {}
    for (path, leaf), sh in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree.leaves(shardings)):
        out[RS.path_str(path)] = math.prod(sh.shard_shape(leaf.shape)) \
            * np.dtype(leaf.dtype).itemsize
    return out


def _gen():
    return torch.Generator("cpu").manual_seed(0)


def _port_params(arch):
    spec = get_arch(arch)
    g = _gen()
    if spec.family == "lm":
        return transformer.init_params(g, spec.config, device="meta")
    if spec.family == "gnn":
        return dimenet.init_params(g, spec.config, d_feat=100,
                                   device="meta")
    return recsys.INIT[arch](g, spec.config, device="meta")


def _ref_params(arch):
    spec = RC.get_arch(arch)
    key = jax.random.PRNGKey(0)
    if spec.family == "lm":
        return jax.eval_shape(lambda: r_transformer.init_params(
            key, spec.config))
    if spec.family == "gnn":
        return jax.eval_shape(lambda: r_dimenet.init_params(
            key, spec.config, d_feat=100))
    return jax.eval_shape(lambda: r_recsys.INIT[arch](key, spec.config))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS + ("dimenet",) + RECSYS_ARCHS)
def test_param_bytes_per_device_equal(arch, mesh_name):
    """Every parameter leaf's per-device bytes equal the reference's
    ``NamedSharding.shard_shape`` under its family rules (an LM's stacked
    leaf: the sum over its layers' port leaves)."""
    ref_mesh, mesh = _meshes(mesh_name)
    fam = get_arch(arch).family
    cfg = get_arch(arch).config
    ref_tree = _ref_params(arch)
    want = _ref_leaf_bytes(ref_tree, RS.tree_shardings(
        ref_mesh, ref_tree, RS.family_rules(fam, ref_mesh)))
    model = _port_params(arch)
    params = dict(model.named_parameters())
    got = defaultdict(int)
    if fam == "lm":
        specs = S._lm_arg_specs(mesh, model, cfg)
        for n, p in params.items():
            got[lm_reference_path(n, cfg)[0]] += S._slice_bytes(
                mesh, *specs[n][:2], p)
    else:
        specs = SH.tree_shardings(mesh, params,
                                  SH.family_rules(fam, mesh))
        for n, p in params.items():
            got[reference_path(n)] += SH.shard_bytes(specs[n], p, mesh)
    assert dict(got) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-236b",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_lm_train_arg_bytes_equal(arch, mesh_name, fsdp, monkeypatch):
    """An LM train cell's per-device arguments (parameters, ZeRO-1
    moments, step, batch; with and without ``LM_FSDP``) equal the
    reference's ``launch/specs`` shardings' shard shapes."""
    from repro import flags as rflags
    from repro.launch import specs as RSP
    from repro.optim import adamw as r_adamw
    monkeypatch.setattr(flags, "LM_FSDP", fsdp)
    monkeypatch.setattr(rflags, "LM_FSDP", fsdp)
    ref_mesh, mesh = _meshes(mesh_name)
    cfg = RC.get_arch(arch).config
    shape = RC.get_arch(arch).shape("train_4k")
    params = _ref_params(arch)
    param_sh = RS.tree_shardings(ref_mesh, params, RS.lm_rules(ref_mesh))
    if fsdp:
        param_sh = RSP._fsdp_shardings(ref_mesh, param_sh, params)
    opt_shape = jax.eval_shape(r_adamw(3e-4).init, params)
    opt_sh = RSP._opt_shardings(ref_mesh, param_sh, opt_shape)
    want = sum(_ref_leaf_bytes(params, param_sh).values()) \
        + sum(_ref_leaf_bytes(opt_shape, opt_sh).values())
    dp = RS.batch_axes(ref_mesh)
    dp_n = math.prod(ref_mesh.shape[a] for a in dp)
    want += 2 * (shape.global_batch // dp_n) * shape.seq_len * 4
    cell = S.build_cell(arch, "train_4k", mesh, device="meta")
    assert cell.arg_bytes == want
    assert cell.kind == "train"
    assert cell.partition == "shards" and "ideal" not in cell.notes


def _spec_shape(spec, shape, mesh):
    return SH.shard_shape(spec, shape, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_lm_batch_and_cache_specs_equal(arch, mesh_name):
    ref_mesh, mesh = _meshes(mesh_name)
    rcfg = RC.get_arch(arch).config
    cfg = get_arch(arch).config
    b, s = 128, 32768
    cache = jax.eval_shape(lambda: r_transformer.init_cache(rcfg, b, s))
    ref_sh = RS.kv_cache_sharding(ref_mesh, cache, rcfg)
    port_cache = transformer.KVCache(*(
        torch.empty(x.shape, dtype=x.dtype, device="meta")
        for x in S._cache_shapes(cfg, b, s)))
    specs = SH.kv_cache_sharding(mesh, port_cache, cfg)
    for field in ("a", "b", "length"):
        x = getattr(port_cache, field)
        assert tuple(getattr(ref_sh, field).shard_shape(
            getattr(cache, field).shape)) == _spec_shape(
                specs[field], x.shape, mesh)
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), np.int32)}
    rb = RS.lm_batch_sharding(ref_mesh, batch)["tokens"]
    pb = SH.lm_batch_sharding(
        mesh, {"tokens": torch.empty((256, 4096), device="meta")})["tokens"]
    assert tuple(rb.shard_shape((256, 4096))) == _spec_shape(
        pb, (256, 4096), mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["full_graph_sm", "molecule",
                                        "ogb_products"])
def test_gnn_batch_specs_equal(shape_name, mesh_name):
    from repro.launch import specs as RSP
    ref_mesh, mesh = _meshes(mesh_name)
    rshape = RC.get_arch("dimenet").shape(shape_name)
    g_ref = RSP._gnn_graph_specs(rshape, ref_mesh.abstract_mesh
                                 if hasattr(ref_mesh, "abstract_mesh")
                                 else ref_mesh)
    shapes = S.gnn_graph_shapes(get_arch("dimenet").shape(shape_name), mesh)
    assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in g_ref.items()} == {
        k: (s, str(dt).replace("torch.", "")) for k, (s, dt) in
        shapes.items()}
    ref_sh = RS.gnn_batch_sharding(ref_mesh, g_ref)
    graph = {k: torch.empty(s, dtype=dt, device="meta")
             for k, (s, dt) in shapes.items()}
    specs = SH.gnn_batch_sharding(mesh, graph)
    for k, x in graph.items():
        assert tuple(ref_sh[k].shard_shape(tuple(x.shape))) == \
            _spec_shape(specs[k], x.shape, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_batch_specs_equal(arch, mesh_name):
    from repro.launch import specs as RSP
    ref_mesh, mesh = _meshes(mesh_name)
    for batch in (512, 65536, 1):
        rb = RSP._recsys_batch_specs(RC.get_arch(arch).config, batch)
        ref_sh = RS.recsys_batch_sharding(ref_mesh, rb)
        pb = S._recsys_batch(get_arch(arch).config, batch, "meta", 0)
        specs = SH.recsys_batch_sharding(mesh, pb)
        assert set(rb) == set(pb)
        for k in rb:
            refs = rb[k] if isinstance(rb[k], list) else [rb[k]]
            xs = pb[k] if isinstance(pb[k], list) else [pb[k]]
            sps = specs[k] if isinstance(pb[k], list) else [specs[k]]
            rshs = ref_sh[k] if isinstance(rb[k], list) else [ref_sh[k]]
            for r, x, sp, rsh in zip(refs, xs, sps, rshs):
                assert tuple(r.shape) == tuple(x.shape)
                assert tuple(rsh.shard_shape(r.shape)) == _spec_shape(
                    sp, x.shape, mesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_zero1_and_moment_specs_equal(mesh_name):
    """ZeRO-1 over the data axes: ``zero1_shardings`` and the train
    cells' moments (``_opt_specs``) against the reference's, on
    DimeNet's replicated parameters (ogb_products' features)."""
    from repro.launch import specs as RSP
    from repro.optim import adamw as r_adamw
    ref_mesh, mesh = _meshes(mesh_name)
    params = _ref_params("dimenet")
    param_sh = RS.tree_shardings(ref_mesh, params, RS.gnn_rules(ref_mesh))
    opt_shape = jax.eval_shape(r_adamw(1e-3).init, params)
    ref_z = RS.zero1_shardings(ref_mesh, param_sh, opt_shape)
    ref_o = RSP._opt_shardings(ref_mesh, param_sh, opt_shape)
    model = _port_params("dimenet")
    named = dict(model.named_parameters())
    specs = SH.tree_shardings(mesh, named, SH.gnn_rules(mesh))
    moments = {n: torch.empty(p.shape, device="meta")
               for n, p in named.items()}
    port_z = SH.zero1_shardings(mesh, specs, {"m": moments})["m"]
    port_o = S._opt_specs(mesh, specs, named)
    want_z = _ref_leaf_bytes(opt_shape["m"], ref_z["m"])
    want_o = _ref_leaf_bytes(opt_shape["m"], ref_o["m"])
    got_z = {reference_path(n): SH.shard_bytes(port_z[n], t, mesh)
             for n, t in moments.items()}
    got_o = {reference_path(n): SH.shard_bytes(port_o[n], t, mesh)
             for n, t in moments.items()}
    assert got_z == want_z and got_o == want_o


def test_iter_cells_equal():
    """The same cells in the same order; the skip reasons the reference's
    without its pointer to a design note the repository lacks."""
    for inc in (False, True):
        port = list(iter_cells(include_ann=inc))
        ref = list(RC.iter_cells(include_ann=inc))
        assert [c[:2] for c in port] == [c[:2] for c in ref]
        for (_, _, p), (_, _, r) in zip(port, ref):
            assert (p is None) == (r is None)
            if p:
                assert r.startswith(p)
    from repro_torch.configs import ASSIGNED_ARCHS
    assert ASSIGNED_ARCHS == RC.ASSIGNED_ARCHS


@pytest.mark.parametrize("bf16", [False, True])
def test_input_specs_for_search_equal(bf16, monkeypatch):
    from repro import flags as rflags
    from repro.core.distributed import input_specs_for_search as ref_specs
    from repro_torch.core.distributed import input_specs_for_search
    monkeypatch.setattr(flags, "ANN_BF16_BASE", bf16)
    monkeypatch.setattr(rflags, "ANN_BF16_BASE", bf16)
    cfg = get_arch("ann-laion").config
    for batch, n, shards in ((1024, 300_000, 16), (1024, 10_000_000, 16),
                             (7, 1001, 3)):
        ref = ref_specs(RC.get_arch("ann-laion").config, batch, n, shards)
        port = input_specs_for_search(cfg, batch, n, shards)
        assert tuple(ref["queries"].shape) == tuple(port["queries"].shape)
        assert port["queries"].is_meta
        for field in ref["arrays"]._fields if hasattr(
                ref["arrays"], "_fields") else vars(ref["arrays"]):
            r = getattr(ref["arrays"], field)
            p = getattr(port["arrays"], field)
            assert tuple(r.shape) == tuple(p.shape), field
            assert np.dtype(r.dtype).name == \
                str(p.dtype).replace("torch.", ""), field
