"""The port's two-tower model, serve steps and launcher against the
reference's, on the CPU at the smoke config.

The reference's params (``two_tower_init``) are carried across with
``recsys_params_from_jax``; both packages then see the same numpy-made
batch (with a few padded history slots and one all-pad history). The towers
are matmuls that XLA and PyTorch round differently, so embeddings and
scores are held to rtol 1e-5 / atol 1e-6; the top-k ids must be equal.
Retrieval through the tuned index (item-tower embeddings as the database,
user-tower embeddings as the queries) reaches the reference's recall@10,
measured in the same test on the same embeddings, within 0.01.
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import FlatIndex as JaxFlatIndex
from repro.core import IndexParams as JaxIndexParams
from repro.core import TunedGraphIndex as JaxTunedGraphIndex
from repro.core import recall_at_k as jax_recall_at_k
from repro.models import recsys as jax_recsys
from repro.serve.serve_step import recsys_retrieval_step as \
    jax_retrieval_step
from repro.serve.serve_step import recsys_score_step as jax_score_step
from repro_torch.carry import recsys_params_from_jax
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.two_tower_retrieval import CONFIG, SMOKE
from repro_torch.core.flat import FlatIndex, recall_at_k
from repro_torch.core.pipeline import IndexParams, TunedGraphIndex
from repro_torch.data import recsys_batch
from repro_torch.models import recsys
from repro_torch.models.recsys_common import padded_rows, table_offsets
from repro_torch.serve.serve_step import recsys_retrieval_step, \
    recsys_score_step, top_k

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
# examples/serve_retrieval.py's index over the item tower's embeddings
ANN_PARAMS = dict(pca_dim=SMOKE.embed_dim, antihub_keep=1.0, ep_clusters=16,
                  ef_search=64, graph_degree=16, build_knn_k=16,
                  build_candidates=48, knn_backend="exact",
                  finish_backend="host")
N_ITEMS = 500
RECALL_MARGIN = 0.01


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
def models():
    params = jax_recsys.two_tower_init(jax.random.PRNGKey(0), SMOKE)
    return params, recsys_params_from_jax(params, SMOKE, device="cpu")


def _batch(b, seed, pads=True):
    rng = np.random.default_rng(seed)
    sparse = [rng.integers(0, v, (b, m)).astype(np.int32)
              for v, m in zip(SMOKE.table_vocabs, SMOKE.multi_hot)]
    if pads:
        sparse[1][1, 5:] = -1
        sparse[1][2] = -1
    return sparse


def _jax(sparse):
    return {"sparse_ids": [jnp.asarray(s) for s in sparse]}


def _torch(sparse):
    return {"sparse_ids": [torch.from_numpy(s) for s in sparse]}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_registry_lists_what_the_port_runs():
    assert list_archs() == ["ann-laion", "deepseek-moe-16b",
                            "deepseek-v2-236b", "dimenet", "din",
                            "dlrm-mlperf", "mistral-nemo-12b", "qwen2-1.5b",
                            "qwen3-32b", "sasrec", "two-tower-retrieval"]
    assert get_arch("two-tower-retrieval").config == CONFIG
    ref = jax_get_arch("two-tower-retrieval")
    assert (CONFIG.table_vocabs, CONFIG.embed_dim, CONFIG.tower_mlp,
            CONFIG.multi_hot) == (ref.config.table_vocabs,
                                  ref.config.embed_dim, ref.config.tower_mlp,
                                  ref.config.multi_hot)
    for arch in ("deepseek-v2-236b", "deepseek-moe-16b", "dimenet"):
        assert vars(get_arch(arch).config) == vars(jax_get_arch(arch).config)
    with pytest.raises(KeyError):
        get_arch("bogus")
    # the full config's table: 14,010,368 rows x 256 f32 = 14.35 GB
    assert padded_rows(CONFIG.table_vocabs) == 14_010_368
    np.testing.assert_array_equal(table_offsets(CONFIG.table_vocabs),
                                  [0, 10_000_000, 12_000_000, 14_000_000])


def test_carried_params_keep_the_reference_layout(models):
    params, model = models
    np.testing.assert_array_equal(model.table.detach().numpy(),
                                  np.asarray(params["table"]))
    for tower in ("user_tower", "item_tower"):
        mlp = getattr(model, tower)
        for lyr, w, b in zip(params[tower]["layers"], mlp.weights,
                             mlp.biases):
            assert tuple(w.shape) == lyr["w"].shape      # (in, out)
            np.testing.assert_array_equal(w.detach().numpy(),
                                          np.asarray(lyr["w"]))
            np.testing.assert_array_equal(b.detach().numpy(),
                                          np.asarray(lyr["b"]))


def test_user_and_item_embeddings_match(models):
    params, model = models
    sparse = _batch(16, seed=1)
    with torch.inference_mode():
        u = model.user_embed(_torch(sparse))
        v = model.item_embed(torch.from_numpy(sparse[2][:, 0]),
                             torch.from_numpy(sparse[3][:, 0]))
    _close(u, jax_recsys.user_embed(params, SMOKE, _jax(sparse)))
    _close(v, jax_recsys.item_embed(params, SMOKE,
                                    jnp.asarray(sparse[2][:, 0]),
                                    jnp.asarray(sparse[3][:, 0])))
    assert u.shape == (16, SMOKE.tower_mlp[-1])
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=1), 1.0,
                               rtol=1e-6)


def test_score_step_matches(models):
    params, model = models
    sparse = _batch(32, seed=2)
    got = recsys_score_step(SMOKE)(model, _torch(sparse))
    want = jax_score_step(SMOKE)(params, _jax(sparse))
    assert got.shape == (32,) and got.dtype == torch.float32
    _close(got, want)


def test_retrieval_step_matches(models):
    params, model = models
    sparse = _batch(1, seed=3, pads=False)
    cands = np.arange(512, dtype=np.int32)
    top, ids = recsys_retrieval_step(SMOKE, k=5)(
        model, _torch(sparse), torch.from_numpy(cands))
    jtop, jids = jax_retrieval_step(SMOKE, k=5)(params, _jax(sparse),
                                                jnp.asarray(cands))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(top.numpy(), np.asarray(jtop), rtol=RTOL)
    # well posed: the 5th and 6th reference scores are further apart than
    # the tolerance, so rounding cannot swap them
    scores = np.sort(np.asarray(jax_recsys.two_tower_retrieval(
        params, SMOKE, _jax(sparse), jnp.asarray(cands),
        jnp.asarray(cands % SMOKE.table_vocabs[3]))))[::-1]
    assert scores[4] - scores[5] > RTOL * abs(scores[4]) + ATOL


def test_top_k_breaks_ties_by_lower_position():
    scores = torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1, 0.5])
    top, idx = top_k(scores, 4)
    assert idx.tolist() == [1, 3, 0, 2]
    want = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)[1]
    assert idx.tolist() == np.asarray(want).tolist()


def test_recsys_batch_shapes_dtypes_ranges():
    g = torch.Generator().manual_seed(0)
    b = recsys_batch(g, 64, SMOKE)
    assert [tuple(s.shape) for s in b["sparse_ids"]] == \
        [(64, m) for m in SMOKE.multi_hot]
    for s, vocab in zip(b["sparse_ids"], SMOKE.table_vocabs):
        assert s.dtype == torch.int32
        assert int(s.min()) >= 0 and int(s.max()) < vocab
    assert b["label"].dtype == torch.float32 and b["label"].shape == (64,)
    assert set(b["label"].unique().tolist()) <= {0.0, 1.0}
    assert "dense" not in b and "history" not in b
    big = recsys_batch(torch.Generator().manual_seed(1), 20000, SMOKE)
    assert abs(float(big["label"].mean()) - 0.3) < 0.02
    again = recsys_batch(torch.Generator().manual_seed(0), 64, SMOKE)
    assert all(torch.equal(x, y) for x, y in zip(b["sparse_ids"],
                                                 again["sparse_ids"]))


def test_other_families_raise_naming_their_item():
    """A config of another family is no recsys family, as in the
    reference: a GNN's (dimenet, ported) and an LM's (the MoE / MLA
    deepseek-v2-236b's too, which builds as an LM) raise KeyError."""
    cfg = get_arch("dimenet").smoke_config
    with pytest.raises(KeyError):
        recsys.family_of(cfg)
    with pytest.raises(KeyError):
        jax_recsys.family_of(jax_get_arch("dimenet").smoke_config)
    cfg = jax_get_arch("deepseek-v2-236b").smoke_config
    with pytest.raises(KeyError):
        recsys.family_of(cfg)
    from repro_torch.models import transformer
    model = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    assert model.blocks[1].moe is not None and "wkv_b" in model.blocks[0].attn


def test_serve_launcher_on_the_cpu_prints_the_reference_line(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "two-tower-retrieval", "--batch", "8", "--device", "cpu"],
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, check=True, timeout=120)
    assert re.fullmatch(
        r"two-tower-retrieval: scored batch 8 \(mean -?\d+\.\d{4}\); "
        r"retrieval top5 ids \[ *\d+( +\d+){4}\]\n", out.stdout), out.stdout
    # the ANN family's --shards (ROADMAP Queue 1 item 9) serves now
    from repro_torch.launch.serve import main
    main(["--arch", "ann-laion", "--device", "cpu", "--shards", "2",
          "--spec", "Flat", "--buckets", "off"])
    assert re.fullmatch(r"ann-laion \[Flat\]: \d+ QPS, recall@10=1\.0000\n",
                        capsys.readouterr().out)


def test_retrieval_through_the_tuned_index(models):
    """examples/serve_retrieval.py steps 2-4 in both packages on the same
    carried towers: recall@10 of the tuned NSG index against brute force
    over the 500-item corpus, for 64 user requests."""
    params, model = models
    items = np.arange(N_ITEMS, dtype=np.int32) % SMOKE.table_vocabs[2]
    cates = items % SMOKE.table_vocabs[3]
    sparse = _batch(64, seed=99, pads=False)

    corpus_j = jax_recsys.item_embed(params, SMOKE, jnp.asarray(items),
                                     jnp.asarray(cates))
    users_j = jax_recsys.user_embed(params, SMOKE, _jax(sparse))
    index_j = JaxTunedGraphIndex(JaxIndexParams(**ANN_PARAMS)).fit(corpus_j)
    _, exact_j = JaxFlatIndex(corpus_j).search(users_j, 10)
    _, approx_j = index_j.search(users_j, 10)
    recall_j = float(jax_recall_at_k(approx_j, exact_j))

    with torch.inference_mode():
        corpus = model.item_embed(torch.from_numpy(items),
                                  torch.from_numpy(cates))
        users = model.user_embed(_torch(sparse))
    _close(corpus, corpus_j)
    index = TunedGraphIndex(IndexParams(**ANN_PARAMS), device="cpu").fit(
        corpus)
    _, exact = FlatIndex(corpus).search(users, 10)
    _, approx = index.search(users, 10)
    recall = recall_at_k(approx, exact)
    assert abs(recall - recall_j) <= RECALL_MARGIN, (recall, recall_j)
    assert approx.shape == (64, 10)
    assert bool(((approx >= 0) & (approx < N_ITEMS)).all())
    assert all(len(set(row)) == 10 for row in approx.tolist())
