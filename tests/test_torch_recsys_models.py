"""The port's SASRec, DIN and DLRM serving (``models/layers.py``,
``models/recsys_common.py``, ``models/recsys.py``, the serve steps and the
launcher) against the reference's, on the CPU at each smoke config.

The reference's params are carried across with ``recsys_params_from_jax``
and both packages see the same numpy-made batch (histories with -1 pads,
one history all pads but its last slot). Matmuls and softmaxes round
differently in XLA and PyTorch, so scores are held to the two-tower
tolerances, rtol 1e-5 / atol 1e-6, and the top-k ids must be equal. The
row-sharded lookup and the dot interaction's triangle are exact.
"""
import re
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as jax_layers
from repro.models import recsys as jax_recsys
from repro.models import recsys_common as jax_common
from repro.serve.serve_step import recsys_retrieval_step as \
    jax_retrieval_step
from repro_torch.carry import recsys_params_from_jax
from repro_torch.configs import get_arch
from repro_torch.data import recsys_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import recsys
from repro_torch.models.layers import rms_norm, sdpa
from repro_torch.models.recsys_common import dot_interaction, \
    make_sharded_lookup, padded_rows
from repro_torch.serve import serve_step
from repro_torch.serve.serve_step import chunk_rows, recsys_retrieval_step, \
    recsys_score_step

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ["sasrec", "din", "dlrm-mlperf"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _np_batch(cfg, b, seed):
    """A batch of ``cfg``'s family from numpy: ids per table, dense
    features, histories with -1 pads (row 0 all pads but its last slot),
    their lengths and a target."""
    rng = np.random.default_rng(seed)
    out = {"sparse_ids": [rng.integers(0, v, (b, 1)).astype(np.int32)
                          for v in cfg.table_vocabs]}
    if cfg.n_dense:
        out["dense"] = rng.normal(size=(b, cfg.n_dense)).astype(np.float32)
    if cfg.seq_len and cfg.interaction in ("self-attn-seq", "target-attn"):
        s = cfg.seq_len
        h = rng.integers(0, cfg.table_vocabs[0], (b, s)).astype(np.int32)
        h[rng.random((b, s)) < 0.2] = -1
        h[0, :-1] = -1
        out["history"] = h
        out["history_len"] = rng.integers(1, s + 1, b).astype(np.int32)
        out["target"] = rng.integers(0, cfg.table_vocabs[0], b).astype(
            np.int32)
    return out


def _tree(batch, fn):
    return {k: [fn(x) for x in v] if isinstance(v, list) else fn(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """Per arch: its smoke config, the reference's params (seed 0) and the
    port's model over the same weights."""
    out = {}
    for arch in ARCHS:
        cfg = jax_get_arch(arch).smoke_config
        params = jax_recsys.INIT[arch](jax.random.PRNGKey(0), cfg)
        out[arch] = (cfg, params,
                     recsys_params_from_jax(params, cfg, device="cpu"))
    return out


# -- layers ------------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("causal,heads,kv_heads,q_offset,ragged", [
    (True, 1, 1, 0, False),      # SASRec's attention
    (True, 4, 2, 0, False),      # GQA: two query heads per kv head
    (True, 4, 1, 3, True),       # decode-style offset, ragged kv
    (False, 2, 2, 0, True),
])
def test_sdpa_matches(causal, heads, kv_heads, q_offset, ragged):
    rng = np.random.default_rng(heads * 10 + kv_heads)
    b, sq, skv, hd = 3, 5, 8, 8
    q = rng.normal(size=(b, sq, heads, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv_heads, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv_heads, hd)).astype(np.float32)
    kvl = np.array([8, 3, 1], np.int32) if ragged else None
    got = sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
               q_offset=q_offset,
               kv_len_valid=None if kvl is None else torch.from_numpy(kvl))
    want = jax_layers.sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                           causal=causal, q_offset=q_offset,
                           kv_len_valid=None if kvl is None
                           else jnp.asarray(kvl))
    assert got.shape == (b, sq, heads, hd)
    _close(got, want)


def test_dot_interaction_matches():
    rng = np.random.default_rng(1)
    x = rng.integers(-4, 5, (4, 27, 16)).astype(np.float32)
    got = dot_interaction(torch.from_numpy(x))
    assert got.shape == (4, 27 * 26 // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_common.dot_interaction(jnp.asarray(x))))


# -- the row-sharded lookup -----------------------------------------------------

def test_sharded_lookup_equals_a_plain_take():
    """Four shards on a mesh naming the CPU four times: the masked takes
    summed in shard order give the plain take's rows bit for bit, ids in
    every shard and at each shard's edges."""
    rows = padded_rows((700, 300, 21))
    g = torch.Generator().manual_seed(0)
    table = torch.randn((rows, 16), generator=g)
    mesh = make_host_mesh(data=1, model=4, devices=[CPU] * 4)
    fn = make_sharded_lookup(mesh, rows)
    edges = torch.tensor([0, rows // 4 - 1, rows // 4, rows // 2,
                          3 * rows // 4 - 1, rows - 1], dtype=torch.int64)
    ids = torch.cat([torch.randint(0, rows, (250,), generator=g), edges])
    assert torch.equal(fn(table, ids), table[ids])
    # the reference's lookup on one device is the same plain take
    np.testing.assert_array_equal(
        fn(table, ids).numpy(),
        np.asarray(jnp.asarray(table.numpy())[jnp.asarray(ids.numpy())]))


def test_sharded_lookup_replicates_a_tiny_batch():
    """On a 2 x 2 mesh a batch of ids that does not split over the two
    batch groups (3 ids, one retrieval user's) takes the replicated path:
    still the plain take, bit for bit; an even batch splits."""
    rows = padded_rows((900,))
    table = torch.randn((rows, 8), generator=torch.Generator().manual_seed(1))
    mesh = make_host_mesh(data=2, model=2, devices=[CPU] * 4)
    fn = make_sharded_lookup(mesh, rows)
    for ids in (torch.tensor([5, rows - 1, rows // 2]),
                torch.arange(0, rows, 37)[:24]):
        assert torch.equal(fn(table, ids), table[ids])


def test_dlrm_through_the_sharded_lookup(models):
    """DLRM's forward with the row-sharded lookup on four CPU shards equals
    its forward with the plain take, bit for bit."""
    cfg, _, model = models["dlrm-mlperf"]
    batch = _tree(_np_batch(cfg, 16, 3), torch.from_numpy)
    mesh = make_host_mesh(data=1, model=4, devices=[CPU] * 4)
    fn = make_sharded_lookup(mesh, model.table.shape[0])
    with torch.inference_mode():
        assert torch.equal(model(batch, fn), model(batch))


# -- the models against the reference ------------------------------------------

def test_registry_serves_the_three_models():
    for arch in ARCHS:
        spec = get_arch(arch)
        ref = jax_get_arch(arch)
        assert spec.family == ref.family == "recsys"
        assert asdict(spec.config) == asdict(ref.config)
        assert asdict(spec.smoke_config) == asdict(ref.smoke_config)
        assert recsys.family_of(spec.config) == arch


def test_carried_params_keep_the_reference_layout(models):
    cfg, params, model = models["sasrec"]
    assert torch.equal(model.pos, torch.from_numpy(np.array(params["pos"])))
    assert len(model.blocks) == cfg.n_blocks
    cfg, params, model = models["din"]
    assert len(model.attn.weights) == len(cfg.attn_mlp) + 1
    cfg, params, model = models["dlrm-mlperf"]
    assert model.table.shape == (padded_rows(cfg.table_vocabs),
                                 cfg.embed_dim)


@pytest.mark.parametrize("arch", ARCHS)
def test_score_matches(models, arch):
    cfg, params, model = models[arch]
    batch = _np_batch(cfg, 32, 7)
    got = recsys_score_step(cfg)(model, _tree(batch, torch.from_numpy))
    want = jax_recsys.SCORE[arch](params, cfg, _tree(batch, jnp.asarray))
    assert got.shape == (32,)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_step_matches(models, arch):
    """One user against 512 candidates: scores close, top-10 ids equal."""
    cfg, params, model = models[arch]
    batch = _np_batch(cfg, 1, 11)
    cand = np.arange(512, dtype=np.int32)
    top, ids = recsys_retrieval_step(cfg, k=10)(
        model, _tree(batch, torch.from_numpy), torch.from_numpy(cand))
    jtop, jids = jax_retrieval_step(cfg, k=10)(
        params, _tree(batch, jnp.asarray), jnp.asarray(cand))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(top, jtop)


def test_sasrec_hidden_zeroes_pads(models):
    """A history of pads but its last slot: the hidden states match the
    reference's, whose pad inputs are zeroed after the positional add."""
    cfg, params, model = models["sasrec"]
    batch = _np_batch(cfg, 4, 5)
    with torch.inference_mode():
        got = model.hidden(torch.from_numpy(batch["history"]))
    want = jax_recsys.sasrec_hidden(params, cfg,
                                    jnp.asarray(batch["history"]))
    _close(got, want)


@pytest.mark.parametrize("arch", ["din", "dlrm-mlperf"])
def test_chunked_steps_equal_unchunked(models, monkeypatch, arch):
    """The retrieval and score steps over chunks of a few rows (CHUNK_BYTES
    cut to 37 rows' worth) equal one unchunked pass: rows never
    interact."""
    cfg, _, model = models[arch]
    assert chunk_rows(get_arch(arch).config) is not None
    one = _tree(_np_batch(cfg, 1, 2), torch.from_numpy)
    batch = _tree(_np_batch(cfg, 100, 4), torch.from_numpy)
    cand = torch.arange(300, dtype=torch.int32)
    runs = []
    for chunk_bytes in (37 * serve_step.row_bytes(cfg), 1 << 40):
        monkeypatch.setattr(serve_step, "CHUNK_BYTES", chunk_bytes)
        runs.append(recsys_retrieval_step(cfg, k=20)(model, one, cand)
                    + (recsys_score_step(cfg)(model, batch),))
    assert chunk_rows(cfg) > 1000
    (t1, i1, s1), (t2, i2, s2) = runs
    assert torch.equal(i1, i2)
    torch.testing.assert_close(t1, t2, rtol=1e-6, atol=0)
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)


def test_recsys_batch_has_the_sequences():
    for arch in ("sasrec", "din"):
        cfg = get_arch(arch).smoke_config
        b = recsys_batch(torch.Generator().manual_seed(0), 64, cfg)
        s = cfg.seq_len
        assert b["history"].shape == (64, s) and b["history"].dtype == \
            torch.int32
        assert int(b["history"].min()) >= 0
        assert int(b["history"].max()) < cfg.table_vocabs[0]
        assert 1 <= int(b["history_len"].min()) <= \
            int(b["history_len"].max()) <= s
        assert 0 <= int(b["target"].min()) and \
            int(b["target"].max()) < cfg.table_vocabs[0]
    b = recsys_batch(torch.Generator().manual_seed(0), 8,
                     get_arch("dlrm-mlperf").smoke_config)
    assert "history" not in b and b["dense"].shape == (8, 13)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_prints_the_reference_line(capsys, arch):
    serve_main(["--arch", arch, "--batch", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.fullmatch(
        re.escape(arch) + r": scored batch 8 \(mean -?\d+\.\d{4}\); "
        r"retrieval top5 ids \[ *\d+( +\d+){4}\]\n", out), out
