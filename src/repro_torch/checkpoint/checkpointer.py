"""Checksummed, atomically committed payloads and the async training
``Checkpointer`` (the reference's ``checkpoint/checkpointer.py``).

Layout of one payload directory, byte-compatible with the reference's, so
either package reads what the other wrote:

  manifest.json   keys, shapes, logical dtypes, a ``crc32:%08x`` checksum
                  per array, and the caller's ``meta``
  arrays.npz      the arrays, keyed as in the manifest

``write_payload`` writes into ``<final>.tmp`` and renames it into place, so
a reader never sees half a payload; ``read_payload`` checks every array's
crc32 before it hands the arrays back, and a mismatch raises a typed
``ChecksumError`` (as does an entry the damaged container can no longer
find or parse, where the reference lets numpy's own error through). A
bfloat16 array is stored as its uint16 view and the
manifest keeps the logical dtype; it reads back as a ``torch.bfloat16``
tensor (numpy has no such dtype), every other array as a numpy array.

``Checkpointer`` writes a training state as one payload per step,
``<dir>/step_<n>/``. ``save`` copies the state to host memory on the
caller's thread (the optimizer updates the tensors in place right after),
and a writer thread takes the copies from a bounded queue; ``wait``
drains it and raises a writer's error, ``close`` stops the thread and a
later ``save`` raises. A state is a tree of dicts, lists, tuples,
``nn.Module``s (their ``state_dict()``), tensors, numpy arrays and
scalars, its leaves keyed by path (``0/table``, ``1/leaves/table/acc``).
``restore`` walks the committed steps newest first and skips, with a
warning, one whose checksums or container fail, rebuilds the target's
structure on the target's devices and dtypes, and loads a module's
tensors in place. Orphaned ``*.tmp`` directories of a crashed writer are
removed when a ``Checkpointer`` opens its directory.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import warnings
import zipfile
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

_STEP_RE = re.compile(r"^step_(\d+)$")


class ChecksumError(ValueError):
    """A payload array's bytes do not match its manifest checksum."""


def array_checksum(arr: np.ndarray) -> str:
    """crc32 over the raw bytes, prefixed so the scheme can evolve."""
    return f"crc32:{zlib.crc32(np.ascontiguousarray(arr).tobytes()):08x}"


def _stored(v) -> Tuple[np.ndarray, str]:
    """(the array as stored, its logical dtype name): a tensor goes to the
    host, a bfloat16 one as its uint16 view."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.contiguous().view(torch.int16).numpy().view(
                np.uint16), "bfloat16"
        v = v.numpy()
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":          # an ml_dtypes array
        return v.view(np.uint16), "bfloat16"
    return v, v.dtype.name


def write_payload(final: str, arrays: Dict[str, Any],
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomically commit ``{final}/manifest.json + arrays.npz``.

    Writes into ``{final}.tmp`` then renames — a reader never observes a
    half-written payload, and a crash leaves only a ``.tmp`` orphan. The
    manifest records shape/dtype/checksum per array plus caller ``meta``
    under its own key.
    """
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    stored, dtypes = {}, {}
    for k, v in arrays.items():
        stored[k], dtypes[k] = _stored(v)
    np.savez(os.path.join(tmp, "arrays.npz"), **stored)
    manifest = {
        "keys": sorted(stored),
        "shapes": {k: list(v.shape) for k, v in stored.items()},
        "dtypes": {k: dtypes[k] for k in stored},
        "checksums": {k: array_checksum(v) for k, v in stored.items()},
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                  # atomic commit
    return final


def read_payload(path: str, verify: bool = True
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a payload dir -> (arrays by key, manifest).

    With ``verify`` every array's crc32 is checked against the manifest
    before the bfloat16 view is reapplied; a mismatch raises
    ``ChecksumError`` naming the offending key. Manifests written before
    the checksum scheme (no ``checksums`` entry) load without verification.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    try:
        data = np.load(os.path.join(path, "arrays.npz"))
    except zipfile.BadZipFile as e:
        raise ChecksumError(f"payload {path!r} npz container unreadable "
                            f"(corrupted or torn write): {e}") from e
    sums = manifest.get("checksums", {})
    out = {}
    for k in manifest["keys"]:
        try:
            arr = data[k]
        except (zipfile.BadZipFile, KeyError, ValueError, EOFError,
                zlib.error) as e:
            # the zip's own per-entry CRC, its directory or the npy header
            # trips before the manifest's crc32 gets a chance: same
            # verdict, same typed error
            raise ChecksumError(f"payload {path!r} array {k!r} unreadable "
                                f"(corrupted bytes): {e}") from e
        if verify and k in sums and array_checksum(arr) != sums[k]:
            raise ChecksumError(
                f"payload {path!r} array {k!r} fails its checksum "
                f"({sums[k]}): corrupted or torn write")
        if manifest["dtypes"].get(k) == "bfloat16":
            arr = torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16)).view(torch.bfloat16)
        out[k] = arr
    return out, manifest


def _items(tree) -> Iterator[Tuple[str, Any]]:
    """(key, child) pairs of one node of a state tree; a module's are its
    ``state_dict`` tensors, with '/' for '.'."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield name.replace(".", "/"), t
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield str(k), tree[k]
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield str(i), v


def _is_node(tree) -> bool:
    return isinstance(tree, (nn.Module, dict, list, tuple))


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, v in _items(tree):
        out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves of a state tree, in key order."""
    return [leaf for _, leaf in _flatten(tree)]


def _host_copy(leaf):
    """A leaf as it is written: a tensor copied to host memory now, so a
    later in-place update cannot reach the writer."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _as_target(arr, target, key: str):
    """A stored array in the target leaf's kind, shape, dtype and device."""
    shape = tuple(arr.shape)
    if isinstance(target, (torch.Tensor, np.ndarray)) and \
            shape != tuple(target.shape):
        raise ValueError(f"{key}: checkpoint {shape} vs target "
                         f"{tuple(target.shape)}")
    if isinstance(target, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        return t.to(device=target.device, dtype=target.dtype)
    if isinstance(target, np.ndarray):
        return np.asarray(arr).astype(target.dtype)
    return type(target)(np.asarray(arr).item())


def _rebuild(target, data: Dict[str, Any], prefix: str = ""):
    def key_of(k):
        return f"{prefix}/{k}" if prefix else k

    if isinstance(target, nn.Module):
        with torch.no_grad():
            for k, t in _items(target):
                t.copy_(_as_target(data[key_of(k)], t, key_of(k)))
        return target
    if isinstance(target, dict):
        return {k: _rebuild(v, data, key_of(str(k)))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        items = [_rebuild(v, data, key_of(str(i)))
                 for i, v in enumerate(target)]
        if hasattr(target, "_fields"):             # a NamedTuple
            return type(target)(*items)
        return type(target)(items)
    leaf = _as_target(data[prefix], target, prefix)
    if isinstance(target, torch.Tensor) and target.requires_grad:
        leaf.requires_grad_(True)
    return leaf


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._gc_orphan_tmps()
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: List[BaseException] = []
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _gc_orphan_tmps(self):
        """Remove ``*.tmp`` dirs a crashed writer left behind: they are by
        construction uncommitted (the rename never happened)."""
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- async save ---------------------------------------------------------
    def save(self, step: int, tree, block: bool = False):
        if self._closed:
            raise RuntimeError(
                "checkpointer closed: save() would enqueue to a dead "
                "worker and wait() would hang forever")
        leaves = [(k, _host_copy(v)) for k, v in _flatten(tree)]
        self._q.put((step, leaves))
        if block:
            self.wait()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self._write(*item)
            except Exception as e:          # handed to the next wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, leaves):
        final = os.path.join(self.dir, f"step_{step:08d}")
        write_payload(final, dict(leaves), meta={"step": step})
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        self._q.join()
        if self._errors:
            # one failure goes to exactly one wait()
            err, self._errors = self._errors[-1], []
            raise err

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed step numbers, ignoring anything that is not a
        ``step_<n>`` dir (``*.tmp`` included)."""
        return sorted(int(m.group(1)) for m in
                      map(_STEP_RE.match, os.listdir(self.dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_tree, step: Optional[int] = None,
                verify: bool = True):
        """Restore into the structure of ``target_tree`` -> (tree, step).

        With ``step=None`` the committed steps are tried newest first: one
        that fails checksum verification or cannot be read is skipped with
        a warning and the next-newest valid step loads. An explicit
        ``step`` raises instead of falling back."""
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data, last_err = None, None
        for s in candidates:
            path = os.path.join(self.dir, f"step_{s:08d}")
            try:
                data, _ = read_payload(path, verify=verify)
                step = s
                break
            except (ChecksumError, OSError, KeyError, ValueError) as e:
                if len(candidates) == 1:
                    raise
                warnings.warn(f"skipping corrupt checkpoint {path}: {e}",
                              RuntimeWarning, stacklevel=2)
                last_err = e
        if data is None:
            raise FileNotFoundError(
                f"no valid checkpoint in {self.dir} "
                f"(newest failure: {last_err})")
        return _rebuild(target_tree, data), step

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=10)
