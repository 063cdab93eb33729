"""The collectives of the reference's LM steps as XLA partitions them over
a (2, 4) ("data", "model") mesh of 8 forced host devices (in a process of
its own, with the rules' shardings and ``set_active_mesh``, as
``src/repro/launch/dryrun.py`` runs them), beside the port's tensor- and
expert-parallel programs counted on a meta (2, 4) mesh, for reduced
qwen2-1.5b (4 heads, 1 KV head, 2 layers), deepseek-moe-16b (1 dense
block, 1 MoE block of 8 experts, top-2) and deepseek-v2-236b (the same,
MLA attention), each with a vocabulary of 512:

    PYTHONPATH=src python tests/tp_collectives.py [arch ...]

Prints one markdown row per cell and side: the collectives by kind
(calls, and the reference's result bytes), the per-device link bytes and
FLOPs. A script beside the tests (pytest collects only ``test_*.py``); it
imports the reference in its subprocess only.
"""
import json
import os
import subprocess
import sys
from dataclasses import replace

import torch

# (name, arch, kind, batch, sequence, head-TP)
CELLS = [("train 4 x 64", "qwen2-1.5b", "train", 4, 64, False),
         ("train 2 x 2048", "qwen2-1.5b", "train", 2, 2048, False),
         ("train 2 x 2048 head-TP", "qwen2-1.5b", "train", 2, 2048, True),
         ("prefill 2 x 2048", "qwen2-1.5b", "prefill", 2, 2048, False),
         ("prefill 2 x 2048 head-TP", "qwen2-1.5b", "prefill", 2, 2048,
          True),
         ("decode 2 x 64", "qwen2-1.5b", "decode", 2, 64, False)] + [
    (name, arch, kind, b, s, head_tp)
    for arch in ("deepseek-moe-16b", "deepseek-v2-236b")
    for name, kind, b, s, head_tp in (
        ("train 4 x 64", "train", 4, 64, False),
        ("prefill 2 x 2048", "prefill", 2, 2048, False),
        ("prefill 2 x 2048 head-TP", "prefill", 2, 2048, True),
        ("decode 2 x 64", "decode", 2, 64, False))]

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import flags
from repro.analysis.hlo import parse_collectives
from repro.analysis.hlo_costs import analyze_module
from repro.configs import get_arch
from repro.configs.base import reduced_lm
from repro.distributed import sharding as SH
from repro.models import transformer as T
from repro.optim import adamw
from repro.train.train_step import loss_fn_for, make_train_step
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 4),
                         ("data", "model"))
SH.set_active_mesh(mesh)
ns = lambda *s: NamedSharding(mesh, P(*s))
dp = ("data",)
out = []
for name, arch, kind, b, s, head_tp in json.loads(sys.argv[1]):
    cfg = reduced_lm(get_arch(arch).config, vocab_size=512)
    ps = jax.eval_shape(lambda: T.init_params(jax.random.PRNGKey(0), cfg))
    psh = SH.tree_shardings(mesh, ps, SH.lm_rules(mesh))
    flags.HEAD_TP_ATTENTION = head_tp
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    if kind == "train":
        opt = adamw(3e-4)
        step = make_train_step(loss_fn_for("lm", cfg), opt)
        comp = jax.jit(step, in_shardings=(psh, None, {
            "tokens": ns(dp, None), "labels": ns(dp, None)})).lower(
            ps, jax.eval_shape(opt.init, ps),
            {"tokens": tok, "labels": tok}).compile()
    elif kind == "prefill":
        def prefill(p, t):
            logits, cache = T.prefill(p, cfg, t)
            return logits[:, -1], cache
        comp = jax.jit(prefill, in_shardings=(psh, ns(dp, None))).lower(
            ps, tok).compile()
    else:
        cs = jax.eval_shape(lambda: T.init_cache(cfg, b, s))
        ids = jax.ShapeDtypeStruct((b,), jnp.int32)
        comp = jax.jit(lambda p, t, c, q: T.decode_step(p, cfg, t, c, q),
                       in_shardings=(psh, ns(dp), SH.kv_cache_sharding(
                           mesh, cs, cfg), ns(dp))).lower(
            ps, ids, cs, ids).compile()
    text = comp.as_text()
    st = parse_collectives(text)
    out.append(dict(counts=st.counts, result_bytes=st.result_bytes,
                    link_bytes=st.link_bytes,
                    flops=analyze_module(text).flops))
print(json.dumps(out))
"""


def reference(cells=CELLS) -> list:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
               JAX_PLATFORMS="cpu")
    return json.loads(subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(cells)],
        capture_output=True, text=True, env=env, check=True).stdout)


def port(cells=CELLS) -> list:
    from repro_torch import flags
    from repro_torch.analysis.op_costs import CostCounter
    from repro_torch.configs import get_arch, reduced_lm
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.serve.serve_step import lm_decode_step, lm_prefill_step
    from repro_torch.train.train_step import loss_fn_for, make_train_step
    meta = torch.device("meta")
    mesh = make_host_mesh(2, 4, devices=[meta] * 8)
    out = []
    for _, arch, kind, b, s, head_tp in cells:
        cfg = replace(reduced_lm(get_arch(arch).config), vocab_size=512)
        sm = SH.shard_lm(T.init_params(torch.Generator().manual_seed(0),
                                       cfg, device=meta), mesh)
        flags.HEAD_TP_ATTENTION = head_tp
        tok = torch.empty((b, s), dtype=torch.int32, device=meta)
        with CostCounter() as c:
            if kind == "train":
                opt = adamw(3e-4)
                make_train_step(loss_fn_for("lm", cfg, mesh=mesh), opt,
                                mesh=mesh)(sm, opt.init(sm),
                                           {"tokens": tok, "labels": tok})
            elif kind == "prefill":
                lm_prefill_step(cfg, mesh)(sm, tok)
            else:
                ids = torch.empty((b,), dtype=torch.int32, device=meta)
                cache = SH.init_sharded_cache(cfg, mesh, b, s, torch.float32)
                lm_decode_step(cfg, mesh)(sm, ids, cache, ids)
        d = c.per_device()
        out.append(dict(counts=dict(d.collective_counts),
                        link_bytes=d.link_bytes, flops=d.total_flops))
    return out


def main() -> None:
    torch.set_num_threads(1)
    archs = sys.argv[1:]
    cells = [c for c in CELLS if not archs or c[1] in archs]
    ref, mine = reference(cells), port(cells)
    print("| Cell | Side | Collectives (calls; reference: result bytes) "
          "| Link bytes / device | FLOPs / device |")
    print("|---|---|---|---|---|")
    for (name, arch, *_), r, p in zip(cells, ref, mine):
        name = f"{arch} {name}"
        kinds = "; ".join(f"{k} {n} ({r['result_bytes'][k]:,} B)"
                          for k, n in sorted(r["counts"].items()))
        print(f"| {name} | reference (XLA) | {kinds} | "
              f"{r['link_bytes']:,.0f} | {r['flops']:,.0f} |")
        kinds = "; ".join(f"{k} {n}" for k, n in sorted(p["counts"].items()))
        print(f"| | port | {kinds} | {p['link_bytes']:,.0f} | "
              f"{p['flops']:,.0f} |")


if __name__ == "__main__":
    main()
