"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the reference package, and no file of the port (nor
``chip_smoke.py``) imports them."""
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
             or m.startswith("repro."))
print(len(names), bad)
"""

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 30
    assert bad == "[]", bad


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []
    for pattern in ("import jax", "from jax", "import repro.",
                    "from repro."):
        assert not any(pattern in f.read_text() for f in files), pattern
