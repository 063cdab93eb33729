"""Build and load the port's CUDA kernels: nvcc into one shared library
with a plain C interface, bound with ctypes.

The library is built at first use, from ``repro_torch/csrc/*.cu``, into
``build/repro_torch_kernels/<hash of the sources>/`` at the checkout's root
(a directory git ignores). Each source compiles in its own nvcc process,
all started together, for ``sm_90a`` (Hopper); one more nvcc call links
them. A failed build raises: nothing falls back to the plain versions.

Every C entry point returns its ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gather_dist_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "beam_hop_f32": [_P] * 11 + [_I] * 7 + [_P],
    "beam_hop_smem_bytes": [_I, _I, _I],
    "topk_merge_rows": [_P] * 6 + [_I] * 5 + [_P],
    "topk_merge_smem_bytes": [_I],
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


_LIBRARY: Optional[KernelLibrary] = None


def sources_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns nvcc's output."""
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    try:
        procs = []
        for src in srcs:
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(log))
        lib_tmp = tmp / "libkernels.so"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(tmp / (s.stem + ".o")) for s in srcs], "-o",
             str(lib_tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + "\n".join(log))
        os.replace(lib_tmp, out_dir / "libkernels.so")   # atomic publish
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> KernelLibrary:
    """The kernel library, built on first use (cached by source hash)."""
    global _LIBRARY
    if _LIBRARY is None:
        out_dir = BUILD_ROOT / sources_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = out_dir / "libkernels.so"
        t0 = time.perf_counter()
        log = ""
        if not lib_path.exists():
            log = _build(out_dir)
            (out_dir / "build.log").write_text(log)
        _LIBRARY = KernelLibrary(lib_path, time.perf_counter() - t0, log)
    return _LIBRARY


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: cudaError_t {code} at launch")
