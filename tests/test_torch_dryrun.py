"""The port's dry run (``launch/specs.py``, ``launch/dryrun.py``) against
the reference's: each family's cells built on a 1 x 1 mesh (kind,
``model_flops``, the inputs' shapes and dtypes), the CLI on ``meta``
writing the reference's record keys, and a 236B-parameter cell run
without allocating its weights."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (before repro.kernels: import order)

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, shape, the argument positions that hold the batch / inputs)
CELLS = [("qwen2-1.5b", "train_4k", (2,)),
         ("qwen2-1.5b", "prefill_32k", (1,)),
         ("qwen2-1.5b", "decode_32k", (1, 2, 3)),
         ("deepseek-v2-236b", "decode_32k", (1, 2, 3)),
         ("dimenet", "molecule", (2,)),
         ("dimenet", "full_graph_sm", (2,)),
         ("sasrec", "train_batch", (2,)),
         ("dlrm-mlperf", "serve_p99", (1,)),
         ("din", "retrieval_cand", (1, 2)),
         ("ann-laion", "search_300k", (0, 1)),
         ("ann-laion", "build_knn", (0, 1, 2))]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_mesh():
    from repro.distributed import sharding as RS
    from repro.launch.mesh import make_host_mesh
    yield make_host_mesh()
    RS.set_active_mesh(None)


def _leaves(x) -> list:
    """(shape, dtype name) of every array in an argument, in a fixed
    order: dicts by key, named tuples and dataclasses by field."""
    if isinstance(x, dict):
        return [y for k in sorted(x) for y in _leaves(x[k])]
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [y for v in x for y in _leaves(v)]
    if hasattr(x, "_fields"):
        return [y for f in x._fields for y in _leaves(getattr(x, f))]
    if hasattr(x, "__dataclass_fields__"):
        return [y for f in x.__dataclass_fields__
                for y in _leaves(getattr(x, f))]
    if isinstance(x, torch.Tensor) or hasattr(x, "copies"):
        return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))]
    return [(tuple(x.shape), np.dtype(x.dtype).name)]


@pytest.mark.parametrize("arch,shape,inputs", CELLS)
def test_cell_matches_reference(arch, shape, inputs, ref_mesh):
    from repro.launch.specs import build_cell as ref_build
    ref = ref_build(arch, shape, ref_mesh)
    mesh = make_mesh((1, 1), ("data", "model"), [torch.device("meta")])
    cell = build_cell(arch, shape, mesh, device="meta")
    assert cell.kind == ref.kind
    assert cell.model_flops == ref.model_flops
    assert len(cell.args) == len(ref.args)
    for i in inputs:
        assert _leaves(cell.args[i]) == _leaves(ref.args[i]), i
    assert cell.partition == "shards" and "ideal" not in cell.notes


REF_KEYS = {"status", "kind", "memory", "arch", "shape", "mesh",
            "n_devices", "flops_per_device", "bytes_per_device",
            "link_bytes_per_device", "compute_s", "memory_s",
            "collective_s", "bottleneck", "model_flops", "useful_ratio",
            "arg_bytes", "temp_bytes", "out_bytes", "collective_counts",
            "notes"}


@pytest.mark.parametrize("arch,shape", [("qwen2-1.5b", "decode_32k"),
                                        ("dimenet", "molecule"),
                                        ("sasrec", "serve_p99"),
                                        ("ann-laion", "search_300k")])
def test_cli_meta_cell_writes_reference_keys(arch, shape, tmp_path):
    """``launch.dryrun --device meta`` on one cell per family exits 0 and
    writes the reference's record keys (``run_s`` for its ``lower_s`` and
    ``compile_s``, ``hbm_fit_80g`` for ``hbm_fit_16g``)."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "single",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.load(open(tmp_path / f"{arch}__{shape}__16x16__torch.json"))
    assert REF_KEYS <= set(rec) and {"run_s", "hbm_fit_80g"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    if arch in ("dimenet", "ann-laion"):       # merged over the mesh
        assert rec["link_bytes_per_device"] > 0


def test_cli_skips_the_reference_cells(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-32b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.count("[SKIP]") == 2 and "ok=0 skip=2 err=0" in out


def test_236b_decode_allocates_nothing():
    """deepseek-v2-236b's decode_32k on meta (its bf16 weights ~470 GB,
    its cache 2.3 TB) raises the process's peak RSS by under 2 GB."""
    code = r"""
import resource, sys, torch
from repro_torch.launch.dryrun import cell_record, count_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
mesh = make_production_mesh(devices=[torch.device("meta")] * 256)
cell = build_cell("deepseek-v2-236b", "prefill_32k", mesh)   # warm imports
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
cell = build_cell("deepseek-v2-236b", "decode_32k", mesh)
weights = sum(p.numel() * p.element_size() for p in cell.args[0].parameters())
rec = cell_record(cell, mesh, "16x16", count_cell(cell))
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(weights, (after - before) * 1024, rec["status"])
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    weights, grown, status = out.stdout.split()
    assert int(weights) > 400e9 and status == "ok"
    assert int(grown) < 2e9
