"""Carry an index or a model across from the reference package.

``index_from_jax_state`` takes what ``repro``'s ``index_state(index)``
returns — or, for its ``TunedGraphIndex``, what ``state_dict()`` returns
(no ``family`` tag) — with every array passed through ``np.asarray``, and
returns the port's index of the same family over the same arrays
(``core.persist.index_from_state``), so both packages search one index.
This module never imports the reference: it reads the plain ``{"family",
"meta", "arrays"}`` layout.

``sharded_index_from_jax`` and ``streamed_sharded_index_from_jax`` carry
the sharded tier: a reference ``ShardedIndex``'s fitted mesh arrays onto a
port mesh (one block per shard), and a reference ``StreamedShardedIndex``'s
host-offload store (its host trees) into the port's store. The factory
wrapper ``ShardedFactoryIndex`` goes through ``index_from_jax_state`` like
every other family (its shards under ``sub<i>/`` keys).

``recsys_params_from_jax`` does the same for the recsys models: it takes
the reference's params pytree of the config's family (two-tower ``{"table",
"user_tower": {"layers": [{"w", "b"}, ...]}, "item_tower"}``, DLRM
``{"table", "bot", "top"}``, DIN ``{"table", "attn", "top"}``, SASRec
``{"table", "pos", "blocks": [{"ln1", "ln2", "wq", ...}], "final_ln"}``)
and returns the port's module over the same weights.

``lm_params_from_jax`` carries the LMs: the reference's params
``{"embed", "final_norm", "dense_layers": [...], "layers": {...},
["lm_head"]}``, whose ``layers`` stacks the homogeneous layers' leaves on
axis 0 behind an MoE config's leading ``dense_layers``, become the port's
``TransformerLM`` with one block per layer, the dense ones first;
``lm_named_from_jax`` flattens an LM params-shaped tree (gradients, AdamW
moments) into the port's names (``dense_layers/0/ffn/w_up`` is
``blocks.0.ffn.w_up``; with one dense layer ``layers/moe/shared/w_up``
slice i is ``blocks.<i + 1>.moe.shared.w_up``). bf16 leaves cross
through their 16-bit view, bit for bit.

``gnn_params_from_jax`` carries DimeNet: the reference's params
``{"embed", "rbf_proj", "msg_init": {"layers": [...]}, "out_final",
"blocks": [{"w_src", "w_kj", "rbf_gate", "sbf_proj", "bilinear", "update",
"out_node"}, ...]}`` become the port's ``models.dimenet.DimeNet`` over the
same weights, bit for bit.

``param_name`` names a reference params leaf by the port's parameter name
(``["user_tower", "layers", 0, "w"]`` is ``user_tower.weights.0``,
``["blocks", 1, "wq"]`` is ``blocks.1.wq``), ``named_from_jax`` flattens a
params-shaped tree (params or gradients) into ``{name: tensor}``, and
``optimizer_state_from_jax`` turns the state of the reference's ``adamw``
(``{"m", "v", "step"}``) or ``mixed_optimizer`` (``{"leaves": {... {"acc"}
or {"m", "v"}}, "step"}``) into the port's, so both packages can take the
next step from one state.
"""
from __future__ import annotations

from dataclasses import asdict

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.core.persist import index_from_state
from repro_torch.models import recsys
from repro_torch.models.layers import MLP


def index_from_jax_state(state: dict, device=None):
    """Reference index state (numpy arrays) -> the port's index of the same
    family on ``device`` (default: the card); a state without a
    ``family`` tag is a ``TunedGraphIndex``'s."""
    arrays = {k: np.asarray(v) for k, v in state["arrays"].items()}
    return index_from_state({"family": state.get("family",
                                                 "TunedGraphIndex"),
                             "meta": state["meta"], "arrays": arrays},
                            device=device)


def _tensor(a) -> torch.Tensor:
    """A numpy-readable array as a tensor of its dtype; a bfloat16 one
    (an ml_dtypes array) through its 16-bit view, bit for bit."""
    a = np.array(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def sharded_index_from_jax(ref, mesh):
    """A fitted reference ``ShardedIndex`` -> the port's over ``mesh``
    (whose ``model`` axis must have the reference mesh's shard count):
    its arrays (a bf16 base stays bf16), structural neighbors, kNN table,
    medoids, padded row count and params; the per-shard sub-indexes are
    not carried (nothing on the serving or reprune path reads them)."""
    from repro_torch.core.distributed import ShardedIndex, ShardedIndexArrays
    from repro_torch.core.pipeline import IndexParams
    from repro_torch.distributed.sharding import put_row_sharded

    idx = ShardedIndex(IndexParams(**asdict(ref.params)), mesh)
    a = ref.arrays

    def rows(x, dtype=None):
        t = _tensor(x)
        return put_row_sharded(mesh, t if dtype is None else t.to(dtype))

    nbrs = rows(a.neighbors, torch.int32)
    idx.arrays = ShardedIndexArrays(
        base=rows(a.base), neighbors=nbrs,
        global_ids=rows(a.global_ids, torch.int32),
        centroids=rows(a.centroids, torch.float32),
        members=rows(a.members, torch.int32),
        pca_mean=_tensor(a.pca_mean).float().to(idx.device),
        pca_comp=_tensor(a.pca_comp).float().to(idx.device),
        base_norms=None if a.base_norms is None
        else rows(a.base_norms, torch.float32))
    idx.struct_neighbors = nbrs if ref.struct_neighbors is a.neighbors \
        else rows(ref.struct_neighbors, torch.int32)
    idx.knn_ids = rows(ref.knn_ids, torch.int32)
    idx.medoids = rows(ref.medoids, torch.int32)
    idx._m = int(ref._m)
    idx.n_structural_builds = int(ref.n_structural_builds)
    return idx


def streamed_sharded_index_from_jax(ref, device=None):
    """A fitted reference ``StreamedShardedIndex`` -> the port's on
    ``device`` (default: the card): every shard's host tree copied into
    the port's store (pinned on CUDA), the global projection, the padded
    row count and the build counters."""
    from repro_torch.core.distributed import StreamedShardedIndex
    from repro_torch.core.pipeline import IndexParams

    idx = StreamedShardedIndex(IndexParams(**asdict(ref.params)),
                               n_shards=ref.n_shards, device=device)
    for key in ref.store.keys():
        idx.store.offload(key, {k: _tensor(v) for k, v in
                                ref.store.peek_host(key).items()})
    idx._structural = idx.store
    idx.pca_mean = _tensor(ref.pca_mean).float().to(idx.device)
    idx.pca_comp = _tensor(ref.pca_comp).float().to(idx.device)
    idx._m = int(ref._m)
    idx.input_dim = int(ref.input_dim)
    idx.n_structural_builds = int(ref.n_structural_builds)
    idx.shard_stats = list(ref.shard_stats)
    return idx


def recsys_params_from_jax(params: dict, cfg, device=None):
    """Reference recsys params (any array type numpy reads) -> the port's
    model of ``cfg``'s family on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def t(a):
        return _tensor(a).to(dev)

    def mlp(p):
        return MLP([t(lyr["w"]) for lyr in p["layers"]],
                   [t(lyr["b"]) for lyr in p["layers"]])

    fam = recsys.family_of(cfg)
    table = t(params["table"])
    if fam == "two-tower-retrieval":
        return recsys.TwoTower(cfg, table, mlp(params["user_tower"]),
                               mlp(params["item_tower"]))
    if fam == "dlrm-mlperf":
        return recsys.DLRM(cfg, table, mlp(params["bot"]),
                           mlp(params["top"]))
    if fam == "din":
        return recsys.DIN(cfg, table, mlp(params["attn"]),
                          mlp(params["top"]))
    return recsys.SASRec(cfg, table, t(params["pos"]),
                         [{k: t(v) for k, v in blk.items()}
                          for blk in params["blocks"]],
                         t(params["final_ln"]))


def gnn_params_from_jax(params: dict, cfg, device=None):
    """Reference DimeNet params -> the port's ``DimeNet`` of ``cfg`` on
    ``device`` (default: the card), the same weights bit for bit."""
    from repro_torch.models.dimenet import Block, DimeNet

    dev = resolve_device(device)

    def t(a):
        return _tensor(a).to(dev)

    def mlp(p):
        return MLP([t(lyr["w"]) for lyr in p["layers"]],
                   [t(lyr["b"]) for lyr in p["layers"]])

    blocks = [Block(t(b["w_src"]), t(b["w_kj"]), t(b["rbf_gate"]),
                    t(b["sbf_proj"]), t(b["bilinear"]), mlp(b["update"]),
                    mlp(b["out_node"]))
              for b in params["blocks"]]
    if len(blocks) != cfg.n_blocks:
        raise ValueError(f"gnn_params_from_jax: {len(blocks)} blocks, the "
                         f"config has {cfg.n_blocks}")
    return DimeNet(t(params["embed"]), t(params["rbf_proj"]),
                   mlp(params["msg_init"]), mlp(params["out_final"]),
                   blocks)


def _lm_leaves(tree):
    """(port name, array) pairs of a reference LM params-shaped tree: the
    leading ``dense_layers[i]`` are ``blocks.<i>``, and the stacked
    ``layers`` sliced on axis 0 follow them (slice j is ``blocks.<n_dense
    + j>``), an MoE layer's ``moe`` subtree with them."""
    for keys, a in _path_keys({k: v for k, v in tree.items()
                               if k not in ("layers", "dense_layers")}):
        yield ".".join(keys), np.asarray(a)
    dense = tree.get("dense_layers") or []
    for i, layer in enumerate(dense):
        for keys, a in _path_keys(layer):
            yield ".".join(("blocks", str(i)) + keys), np.asarray(a)
    for keys, a in _path_keys(tree["layers"]):
        a = np.asarray(a)
        for j in range(a.shape[0]):
            yield ".".join(("blocks", str(len(dense) + j)) + keys), a[j]


def lm_named_from_jax(tree: dict, device=None) -> dict:
    """A reference LM params-shaped tree -> {port name: tensor} on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {name: _tensor(a).to(dev) for name, a in _lm_leaves(tree)}


def lm_params_from_jax(params: dict, cfg, device=None):
    """Reference LM params -> the port's ``TransformerLM`` of ``cfg`` on
    ``device`` (default: the card), the same weights bit for bit."""
    return lm_from_named(lm_named_from_jax(params, device), cfg)


def lm_from_named(named: dict, cfg):
    """{port parameter name: tensor} -> a ``TransformerLM`` of ``cfg``
    holding those tensors (wrapped as parameters, not copied)."""
    from repro_torch.models.moe import MoE
    from repro_torch.models.transformer import Block, TransformerLM

    def group(part, name):
        sub = {k[len(name) + 1:]: v for k, v in part.items()
               if k.startswith(name + ".")}
        return sub or None

    def pdict(tensors):
        return nn.ParameterDict({k: nn.Parameter(v)
                                 for k, v in tensors.items()})

    blocks = []
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        part = {k[len(pre):]: v for k, v in named.items()
                if k.startswith(pre)}
        ffn, moe = group(part, "ffn"), group(part, "moe")
        if moe is not None:
            shared = group(moe, "shared")
            moe = MoE(moe["router"], moe["w_gate"], moe["w_up"],
                      moe["w_down"], None if shared is None
                      else pdict(shared))
        blocks.append(Block(part["ln1"], part["ln2"],
                            pdict(group(part, "attn")),
                            ffn=None if ffn is None else pdict(ffn),
                            moe=moe))
    return TransformerLM(cfg, named["embed"], named["final_norm"], blocks,
                         named.get("lm_head"))


def _path_keys(tree, prefix=()):
    """(keys, leaf) pairs of a nested dict / list tree of arrays."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_keys(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_keys(v, prefix + (i,))
    else:
        yield prefix, tree


def param_name(keys) -> str:
    """A reference params path -> the port's parameter name: an MLP's
    ``layers/<i>/w`` and ``/b`` are its ``weights.<i>`` and ``biases.<i>``,
    every other path joins with '.'."""
    keys = list(keys)
    if "layers" in keys:
        i = keys.index("layers")
        kind = {"w": "weights", "b": "biases"}[keys[i + 2]]
        keys = keys[:i] + [kind, keys[i + 1]] + keys[i + 3:]
    return ".".join(str(k) for k in keys)


def reference_path(name: str) -> str:
    """A port parameter name -> the reference's params path, the inverse of
    ``param_name``: an MLP's ``weights.<i>`` / ``biases.<i>`` are its
    ``layers/<i>/w`` / ``b``, every other dot a '/'."""
    keys = name.split(".")
    for i, k in enumerate(keys[:-1]):
        if k in ("weights", "biases"):
            keys = keys[:i] + ["layers", keys[i + 1],
                               "w" if k == "weights" else "b"] + keys[i + 2:]
            break
    return "/".join(keys)


def lm_reference_path(name: str, cfg):
    """A ``TransformerLM`` parameter name -> (the reference's path, the
    leading dims of its stacked leaf), the inverse of ``_lm_leaves``:
    ``blocks.<i>`` is ``dense_layers/<i>`` for an MoE config's leading
    dense layers, else slice i - n_dense of the stacked ``layers`` (whose
    leaf has n_layers - n_dense rows in front)."""
    keys = name.split(".")
    if keys[0] != "blocks":
        return "/".join(keys), ()
    i = int(keys[1])
    n_dense = cfg.first_dense_layers if cfg.moe else 0
    if i < n_dense:
        return "/".join(["dense_layers", str(i)] + keys[2:]), ()
    return "/".join(["layers"] + keys[2:]), (cfg.n_layers - n_dense,)


def named_from_jax(tree, device=None) -> dict:
    """A reference params-shaped tree -> {port name: tensor} on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return {param_name(keys): _tensor(a).to(dev)
            for keys, a in _path_keys(tree)}


def optimizer_state_from_jax(state: dict, device=None) -> dict:
    """The reference's ``adamw`` or ``mixed_optimizer`` state -> the
    port's, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                        device=dev)
    if "leaves" not in state:
        return {"m": named_from_jax(state["m"], dev),
                "v": named_from_jax(state["v"], dev), "step": step}
    leaves = {}
    for keys, a in _path_keys(state["leaves"]):
        leaves.setdefault(param_name(keys[:-1]), {})[keys[-1]] = \
            _tensor(a).to(dev)
    return {"leaves": leaves, "step": step}
