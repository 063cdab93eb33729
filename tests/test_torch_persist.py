"""Snapshots across the two packages: the payload format, every factory
family's state in both directions, corruption and validation.

* Payloads: what the port's ``write_payload`` writes, the reference's
  ``read_payload`` reads, and the reverse, with identical checksum strings
  (bfloat16 included: the port reads it back as a ``torch.bfloat16``
  tensor without ``ml_dtypes``).
* Every ``available_factories()`` example plus ``PCA24,Flat``,
  ``PCA24,IVF16`` and ``PCA24,HNSW8``, built by the reference on integer
  data: its snapshot loads in the port (checksums verified, invariants
  validated) and searches exactly like the reference's own index (ids and
  dists; a PQ spec sums float LUT entries, so its dists to rtol 1e-6; a
  PCA spec projects, so its dists to 1e-6 of |q|^2 + |x|^2, the scale of
  the norm expansion's rounding). The port's
  snapshot of the same spec loads in the reference with the same manifest
  keys, dtypes and shapes (a posting list's width depends on the
  clustering), and the reference's search of it equals the port's.
* Corruption fails closed, a stepped directory falls back past a corrupt
  newest step, and each ``validate_index`` check names its invariant.
"""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels need core first)
from repro.checkpoint.checkpointer import read_payload as jax_read_payload
from repro.checkpoint.checkpointer import write_payload as jax_write_payload
from repro.core import build_index as jax_build_index
from repro.core import load_index as jax_load_index
from repro.core import save_index as jax_save_index
from repro.core.index_api import available_factories as jax_factories
from repro_torch.checkpoint.checkpointer import (
    ChecksumError, array_checksum, read_payload, write_payload,
)
from repro_torch.core.index_api import available_factories, build_index
from repro_torch.core.persist import (
    index_from_state, index_state, load_index, save_index,
)
from repro_torch.core.pq import PQIndex
from repro_torch.core.validate import IndexIntegrityError, validate_index
from repro_torch.serve.faults import corrupt_payload

EXAMPLES = sorted({s for specs in available_factories().values()
                   for s in specs})
PCA_SPECS = ["PCA24,Flat", "PCA24,IVF16", "PCA24,HNSW8"]
KEY = jax.random.PRNGKey(0)
# ADC distances sum LUT entries made from k-means means (floats), in
# another order than the reference's jnp.sum: equal to rtol 1e-6
ADC_SPECS = ("PQ8", "IVF16,PQ8", "IVFPQ16x8")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other made this module's many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_examples_are_the_references():
    assert EXAMPLES == sorted({s for specs in jax_factories().values()
                               for s in specs})


@pytest.fixture(scope="module")
def int_data():
    """Integer rows around 8 centers: every distance is an exact integer
    in both packages."""
    rng = np.random.default_rng(21)
    centers = rng.integers(-12, 13, (8, 32))
    x = centers[rng.integers(0, 8, 900)] + rng.integers(-3, 4, (900, 32))
    q = centers[rng.integers(0, 8, 24)] + rng.integers(-3, 4, (24, 32))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.fixture(scope="module")
def jax_built(int_data):
    """One reference build per spec, made on first use."""
    cache = {}

    def get(spec):
        if spec not in cache:
            cache[spec] = jax_build_index(spec, jnp.asarray(int_data[0]),
                                          key=KEY)
        return cache[spec]
    return get


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _same_search(port_idx, jax_idx, x, q, spec):
    gd, gi = port_idx.search(torch.from_numpy(q), 10)
    wd, wi = jax_idx.search(jnp.asarray(q), 10)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=spec)
    if spec.startswith("PCA"):
        # projected rows are floats, and the norm expansion's rounding is
        # relative to |q|^2 + |x|^2, not to the distance
        pq = port_idx.pca.transform(torch.from_numpy(q)).numpy()
        px = port_idx.pca.transform(torch.from_numpy(x)).numpy()
        scale = (pq ** 2).sum(1)[:, None] + (px ** 2).sum(1).max()
        assert (np.abs(gd.numpy() - np.asarray(wd))
                <= 1e-6 * scale).all(), spec
    elif spec in ADC_SPECS:
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                                   err_msg=spec)
    else:
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd),
                                      err_msg=spec)


@pytest.mark.parametrize("spec", EXAMPLES + PCA_SPECS)
def test_reference_snapshot_loads_in_the_port(spec, int_data, jax_built,
                                              tmp_path):
    x, q = int_data
    want = jax_built(spec)
    snap = str(tmp_path / "snap")
    jax_save_index(want, snap)
    got = load_index(snap, device="cpu")        # checksums + invariants
    assert type(got).__name__ == type(want).__name__
    assert got.spec == spec
    assert got.ntotal == want.ntotal and got.dim == want.dim
    assert got.memory_bytes() == want.memory_bytes()
    _same_search(got, want, x, q, spec)


@pytest.mark.parametrize("spec", EXAMPLES + PCA_SPECS)
def test_port_snapshot_loads_in_the_reference(spec, int_data, jax_built,
                                              tmp_path):
    x, q = int_data
    got = build_index(spec, x, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    snap, ref_snap = str(tmp_path / "port"), str(tmp_path / "ref")
    save_index(got, snap)
    jax_save_index(jax_built(spec), ref_snap)
    mine, theirs = _manifest(snap), _manifest(ref_snap)
    assert mine["keys"] == theirs["keys"]
    assert mine["dtypes"] == theirs["dtypes"]
    for k in mine["keys"]:
        a, b = mine["shapes"][k], theirs["shapes"][k]
        if k.rsplit("/", 1)[-1] in ("lists", "list_codes"):
            a, b = a[:1] + a[2:], b[:1] + b[2:]     # cap: the clustering's
        assert a == b, k
    assert sorted(mine["meta"]) == sorted(theirs["meta"])
    assert mine["meta"]["spec"] == spec
    want = jax_load_index(snap)
    _same_search(got, want, x, q, spec)


def test_state_is_host_serializable(int_data):
    x, q = int_data
    idx = build_index("IVF16,PQ8", x, device="cpu")
    state = index_state(idx)
    json.dumps(state["meta"])
    assert all(isinstance(v, np.ndarray) for v in state["arrays"].values())
    clone = index_from_state(state, device="cpu")
    _, i0 = idx.search(torch.from_numpy(q), 10)
    _, i1 = clone.search(torch.from_numpy(q), 10)
    assert torch.equal(i0, i1)


# ------------------------------------------------------------ payloads
def _arrays():
    rng = np.random.default_rng(3)
    return {"f": rng.random((5, 3)).astype(np.float32),
            "i": rng.integers(-9, 9, (7,)).astype(np.int32),
            "u": rng.integers(0, 255, (4, 2)).astype(np.uint8),
            "l": np.arange(6, dtype=np.int64),
            "s": np.array(3, np.int32),
            "inner/w": rng.random((2, 2)).astype(np.float32)}


def test_port_payload_reads_in_the_reference(tmp_path):
    arrays = _arrays()
    bf = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7
    path = write_payload(str(tmp_path / "p"), {**arrays,
                                              "b": bf.bfloat16()},
                         meta={"x": 1})
    got, manifest = jax_read_payload(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    assert got["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        got["b"].astype(np.float32), bf.bfloat16().float().numpy())
    assert manifest["meta"] == {"x": 1}
    assert manifest["dtypes"]["b"] == "bfloat16"


def test_reference_payload_reads_in_the_port(tmp_path):
    arrays = _arrays()
    bf = (np.arange(12, dtype=np.float32).reshape(3, 4) / 7).astype(
        ml_dtypes.bfloat16)
    path = jax_write_payload(str(tmp_path / "p"), {**arrays, "b": bf},
                             meta={"y": [1, 2]})
    got, manifest = read_payload(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    assert isinstance(got["b"], torch.Tensor)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  bf.astype(np.float32))
    assert manifest["meta"] == {"y": [1, 2]}


def test_checksums_equal_in_both_packages(tmp_path):
    arrays = _arrays()
    mine = _manifest(write_payload(str(tmp_path / "a"), arrays))
    theirs = _manifest(jax_write_payload(str(tmp_path / "b"), arrays))
    assert mine == theirs
    for k, v in arrays.items():
        assert mine["checksums"][k] == array_checksum(v)
    with open(tmp_path / "a" / "arrays.npz", "rb") as f, \
            open(tmp_path / "b" / "arrays.npz", "rb") as g:
        assert f.read() == g.read()


def test_payload_commit_is_atomic(tmp_path):
    final = str(tmp_path / "p")
    write_payload(final, {"a": np.zeros(3)})
    write_payload(final, {"b": np.ones(2)})           # replaces
    assert not os.path.exists(final + ".tmp")
    got, _ = read_payload(final)
    assert list(got) == ["b"]


def test_corrupt_payload_raises_checksum_error(tmp_path):
    path = write_payload(str(tmp_path / "p"), _arrays())
    corrupt_payload(path, seed=1)
    with pytest.raises(ChecksumError):
        read_payload(path)


# ------------------------------------------------- corruption, fallback
def test_load_rejects_a_corrupted_snapshot(int_data, tmp_path):
    snap = str(tmp_path / "snap")
    save_index(build_index("IVF16", int_data[0], device="cpu"), snap)
    corrupt_payload(snap, seed=3)
    with pytest.raises(IndexIntegrityError) as ei:
        load_index(snap, device="cpu")
    assert ei.value.invariant == "checksum"


def test_stepped_load_falls_back_past_corruption(int_data, tmp_path):
    x, q = int_data
    root = str(tmp_path / "steps")
    idx = build_index("NSG12,EP8", x, device="cpu")
    save_index(idx, root, step=1)
    save_index(idx, root, step=2)
    tmp_dir = os.path.join(root, "step_00000003.tmp")   # a torn write
    os.makedirs(tmp_dir)
    with open(os.path.join(tmp_dir, "arrays.npz"), "wb") as f:
        f.write(b"partial garbage")
    corrupt_payload(os.path.join(root, "step_00000002"), seed=11)
    with pytest.warns(RuntimeWarning, match="step_00000002"):
        loaded = load_index(root, device="cpu")
    _, i0 = idx.search(torch.from_numpy(q), 10)
    _, i1 = loaded.search(torch.from_numpy(q), 10)
    assert torch.equal(i0, i1)


def test_stepped_load_all_corrupt_raises(int_data, tmp_path):
    root = str(tmp_path / "steps")
    save_index(build_index("Flat", int_data[0], device="cpu"), root, step=1)
    corrupt_payload(os.path.join(root, "step_00000001"), seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(IndexIntegrityError):
            load_index(root, device="cpu")


def test_load_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "nope"), device="cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "empty"), device="cpu")


def test_unknown_family_and_non_snapshot_raise(tmp_path):
    with pytest.raises(IndexIntegrityError) as ei:
        index_from_state({"family": "Bogus", "meta": {}, "arrays": {}})
    assert ei.value.invariant == "family"
    write_payload(str(tmp_path / "p"), {"a": np.zeros(2)})
    with pytest.raises(IndexIntegrityError) as ei:
        load_index(str(tmp_path / "p"), device="cpu")
    assert ei.value.invariant == "manifest"


# ------------------------------------------------------------ validate
@pytest.fixture(scope="module")
def nsg(int_data):
    return build_index("NSG12,EP8", int_data[0], device="cpu")


def test_validate_passes_on_fresh_builds(int_data):
    for spec in ("Flat", "IVF16", "IVF16,PQ8", "PQ8", "HNSW8,EP8",
                 "NSG12,EP8,SQ8", "PCA24,IVF16"):
        validate_index(build_index(spec, int_data[0], device="cpu"))


def _raises(idx, invariant):
    with pytest.raises(IndexIntegrityError) as ei:
        validate_index(idx)
    assert ei.value.invariant == invariant


def _clone(idx):
    return index_from_state(index_state(idx), device="cpu")


def test_validate_catches_out_of_range_neighbor(nsg):
    bad = _clone(nsg)
    bad.graph.neighbors[0, 0] = bad.ntotal + 5
    _raises(bad, "neighbor_range")


def test_validate_catches_a_degree_desync(nsg):
    bad = _clone(nsg)
    bad.graph = bad.graph._replace(neighbors=bad.graph.neighbors[:, :8])
    _raises(bad, "degree")


def test_validate_catches_bad_entry_points_and_kept_ids(nsg):
    bad = _clone(nsg)
    bad.eps.member_ids[0] = bad.ntotal
    _raises(bad, "entry_points")
    bad = _clone(nsg)
    bad.kept_idx[3] = -1
    _raises(bad, "kept_idx")


def test_validate_catches_an_unreachable_graph(nsg):
    bad = _clone(nsg)
    bad.graph.neighbors[:] = -1                   # nothing leaves the entries
    _raises(bad, "reachability")


def test_validate_catches_nonfinite_vectors(int_data):
    idx = build_index("Flat", int_data[0].copy(), device="cpu")
    idx.data[3, 1] = float("nan")
    _raises(idx, "finite")


def test_validate_catches_pq_code_overflow(int_data):
    idx = PQIndex(m=8, n_centroids=16, device="cpu").fit(
        torch.from_numpy(int_data[0]))
    idx.codes[0, 0] = 16                          # == n_centroids
    _raises(idx, "pq_codes")


def test_validate_catches_ivf_and_hnsw_faults(int_data):
    x = int_data[0]
    ivf = build_index("IVF16", x, device="cpu")
    ivf.centroids = ivf.centroids[:15]
    _raises(ivf, "ivf_lists")
    ivfpq = build_index("IVFPQ16x8", x, device="cpu")
    ivfpq.list_codes[0, 0, 0] = 1000
    _raises(ivfpq, "pq_codes")
    hnsw = build_index("HNSW8", x, device="cpu")
    hnsw.entry = hnsw.ntotal
    _raises(hnsw, "entry_points")


def test_validate_refuses_an_unknown_family():
    _raises(object(), "family")


def test_validate_catches_codec_and_fit_faults(int_data):
    x = int_data[0]
    ivfpq = build_index("IVFPQ16x8", x, device="cpu")
    ivfpq.pq.codec.codebooks = ivfpq.pq.codec.codebooks[:, :, :2]  # 8x2
    _raises(ivfpq, "pq_geometry")
    sq8 = build_index("NSG12,EP8,SQ8", x, device="cpu")
    sq8.codec.scale = sq8.codec.scale.clone()
    sq8.codec.scale[0] = 0.0
    _raises(sq8, "sq8_scale")
    sq8.codec.scale = sq8.codec.scale[:16].abs() + 1.0
    _raises(sq8, "sq8_geometry")
    from repro_torch.core.flat import FlatIndex
    _raises(FlatIndex(), "fitted")
