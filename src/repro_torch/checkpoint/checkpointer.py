"""Checksummed, atomically committed payloads (the reference's
``checkpoint/checkpointer.py``, its payload half).

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
The reference's async ``Checkpointer`` is not ported (ROADMAP Queue 1 item
10.6).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


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
