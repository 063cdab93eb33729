"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX, nor the reference package, nor ``ml_dtypes`` (the machine
with the card has none), and no file of the port (nor ``chip_smoke.py``)
imports them."""
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "ml_dtypes")
print(len(names), ",".join(bad) or "none", ",".join(names))
"""

# the modules of the unified index API slice; each must be importable
INDEX_API_MODULES = {
    "repro_torch.checkpoint.checkpointer", "repro_torch.core.validate",
    "repro_torch.core.index_api", "repro_torch.core.ivf",
    "repro_torch.core.pq", "repro_torch.core.ivfpq", "repro_torch.core.hnsw",
    "repro_torch.core.persist", "repro_torch.core.batching",
    "repro_torch.serve.resilience", "repro_torch.serve.faults",
    "repro_torch.serve.batching", "repro_torch.serve.serve_step",
    "repro_torch.launch.serve", "repro_torch.launch.tune"}

# the modules of the sharded and out-of-core slice
SHARDED_MODULES = {
    "repro_torch.flags", "repro_torch.launch.mesh",
    "repro_torch.distributed.sharding", "repro_torch.core.build.stream",
    "repro_torch.core.build.shardlocal", "repro_torch.core.distributed"}

# the modules of the recsys training slice
TRAIN_MODULES = {
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.compression", "repro_torch.train",
    "repro_torch.train.train_step", "repro_torch.train.trainer",
    "repro_torch.launch.train"}

# the modules of the dense LM slice
LM_MODULES = {
    "repro_torch.models.transformer", "repro_torch.serve.sampling",
    "repro_torch.configs.qwen2_1_5b", "repro_torch.configs.mistral_nemo_12b",
    "repro_torch.configs.qwen3_32b"}

# the modules of the MoE / MLA slice
MOE_MLA_MODULES = {
    "repro_torch.models.moe", "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.deepseek_v2_236b"}

# the modules of the GNN slice (the sampler is the port's own copy)
GNN_MODULES = {
    "repro_torch.models.dimenet", "repro_torch.data.graph_sampler",
    "repro_torch.configs.dimenet"}

# the modules of the analysis and dry-run slice
DRYRUN_MODULES = {
    "repro_torch.analysis", "repro_torch.analysis.op_costs",
    "repro_torch.analysis.roofline", "repro_torch.analysis.hop_traffic",
    "repro_torch.launch.specs", "repro_torch.launch.dryrun"}

_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)", re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True,
                         timeout=300)
    n, bad, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 30
    assert bad == "none", bad
    assert INDEX_API_MODULES <= set(names.split(",")), \
        INDEX_API_MODULES - set(names.split(","))
    assert SHARDED_MODULES <= set(names.split(",")), \
        SHARDED_MODULES - set(names.split(","))
    assert TRAIN_MODULES <= set(names.split(",")), \
        TRAIN_MODULES - set(names.split(","))
    assert LM_MODULES <= set(names.split(",")), \
        LM_MODULES - set(names.split(","))
    assert MOE_MLA_MODULES <= set(names.split(",")), \
        MOE_MLA_MODULES - set(names.split(","))
    assert GNN_MODULES <= set(names.split(",")), \
        GNN_MODULES - set(names.split(","))
    assert DRYRUN_MODULES <= set(names.split(",")), \
        DRYRUN_MODULES - set(names.split(","))


_LM_PROBE = """
import sys
import repro_torch.models.transformer, repro_torch.serve.sampling
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(",".join(bad) or "none")
"""


def test_the_lm_modules_alone_load_no_jax():
    """``models.transformer`` and ``serve.sampling``, imported on their own
    in a fresh process, load neither JAX nor the reference."""
    out = subprocess.run([sys.executable, "-c", _LM_PROBE],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "none"


def test_the_moe_module_alone_loads_no_jax():
    """``models.moe`` and the two MoE / MLA configs, imported on their own
    in a fresh process, load neither JAX nor the reference."""
    probe = ("import sys\nimport repro_torch.models.moe\n"
             "import repro_torch.configs.deepseek_v2_236b\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'repro.')) or m == 'repro')) or 'none')")
    out = subprocess.run([sys.executable, "-c", probe],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert out.stdout.strip() == "none"


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    for pattern in ("import jax", "from jax", "import repro.",
                    "from repro.", "import ml_dtypes", "from ml_dtypes"):
        assert not any(pattern in f.read_text() for f in files), pattern
