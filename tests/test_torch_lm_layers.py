"""The dense LM's layers in the port (``models/layers.py``: rope,
``sdpa``, ``chunked_sdpa``, ``attention``, ``gqa_*``, ``swiglu_*``)
against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
layers' weights are the reference's init perturbed in every leaf (its
init gives zero biases and unit q/k norms, which would hide them). Float32
results are held to rtol 1e-5 / atol 1e-6: XLA and PyTorch round the
products and sums in other orders. The rope frequencies are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import reduced_lm as jax_reduced_lm
from repro.models import layers as J
from repro_torch.configs import LMConfig, get_arch, reduced_lm
from repro_torch.models import layers as L

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs (the suite runs
    in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _perturbed(tree, seed):
    """Every leaf moved by 0.1 of its own spread (or of 1 where it has
    none: unit norms, zero biases)."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        spread = float(a.std()) or 1.0
        return a + _normal(rng, a.shape, 0.1 * spread)
    return jax.tree.map(move, tree)


# -- configs -----------------------------------------------------------------

LM_IDS = ["qwen2-1.5b", "mistral-nemo-12b", "qwen3-32b"]


def test_configs_match_the_reference():
    for arch in LM_IDS:
        spec, ref = get_arch(arch), jax_get_arch(arch)
        assert spec.family == "lm" and spec.shapes.keys() == ref.shapes.keys()
        assert vars(spec.config) == vars(ref.config)
        assert vars(spec.smoke_config) == vars(ref.smoke_config)
        assert spec.config.param_count() == ref.config.param_count()
        assert spec.config.active_param_count() == \
            ref.config.active_param_count()
        for shape in spec.shapes:
            assert vars(spec.shape(shape)) == vars(ref.shape(shape))
            assert (spec.skip_reason(shape) is None) == \
                (ref.skip_reason(shape) is None)
        assert spec.skip_reason("long_500k").startswith(
            "long_500k needs sub-quadratic attention")
    # the MoE / MLA configs: the registry's, their counts, reduced_lm
    for arch in ("deepseek-v2-236b", "deepseek-moe-16b"):
        big = jax_get_arch(arch).config
        mine = get_arch(arch).config
        assert vars(mine) == vars(big) and mine == LMConfig(**vars(big))
        assert mine.param_count() == big.param_count()
        assert mine.active_param_count() == big.active_param_count()
        over = dict(n_kv_heads=2, head_dim=8)
        assert vars(reduced_lm(mine, **over)) == \
            vars(jax_reduced_lm(big, **over))


# -- rope ----------------------------------------------------------------------

@pytest.mark.parametrize("hd,theta", [(16, 1e6), (128, 1e6), (128, 1e4)])
def test_rope_cache_is_the_reference_bits(hd, theta):
    pos = np.arange(0, 4096, 7, dtype=np.int32).reshape(2, -1)
    cos, sin = L.rope_cache(_t(pos), hd, theta)
    jc, js = J.rope_cache(jnp.asarray(pos), hd, theta)
    assert cos.shape == (2, pos.shape[1], hd // 2) and cos.dtype == \
        torch.float32
    # the angles are the reference's bits; cos / sin within an ulp
    _close(cos, jc, rtol=0, atol=2e-7)
    _close(sin, js, rtol=0, atol=2e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 9, 3, 16))
    pos = rng.integers(0, 3000, (2, 9)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    got = L.apply_rope(_t(x).to(getattr(torch, dtype)),
                       *L.rope_cache(_t(pos), 16, 1e6))
    want = J.apply_rope(jx, *J.rope_cache(jnp.asarray(pos), 16, 1e6))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        _close(got, want)
    else:       # one bf16 rounding of the same float32 value: <= 1 ulp
        _close(got.float(), np.asarray(want.astype(jnp.float32)),
               rtol=2 ** -7, atol=1e-6)


# -- attention -----------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, kv, hd):
    return (_normal(rng, (b, sq, h, hd)), _normal(rng, (b, skv, kv, hd)),
            _normal(rng, (b, skv, kv, hd)))


@pytest.mark.parametrize("causal,q_offset,valid", [
    (True, 0, False), (True, 5, False), (False, 0, True), (True, 3, True)])
def test_sdpa(causal, q_offset, valid):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 3, 6, 11, 4, 2, 8)
    lens = np.array([11, 4, 1], np.int32) if valid else None
    got = L.sdpa(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset,
                 kv_len_valid=None if lens is None else _t(lens))
    want = J.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, q_offset=q_offset,
                  kv_len_valid=None if lens is None else jnp.asarray(lens))
    _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1), (6, 3)])
def test_chunked_sdpa_several_blocks_and_a_padded_tail(causal, h, kv):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 37, 37, h, kv, 8)
    got = L.chunked_sdpa(_t(q), _t(k), _t(v), causal=causal, block_kv=8)
    want = J.chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_kv=8)
    _close(got, want)
    # the same function as sdpa
    _close(got, L.sdpa(_t(q), _t(k), _t(v), causal=causal), rtol=1e-5,
           atol=1e-5)


def test_chunked_sdpa_gradient():
    """Autograd through the in-place block ops equals the reference's
    gradient of the same loss (the training path at S >= 2048)."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 21, 21, 4, 2, 8)
    w = _normal(rng, (2, 21, 4, 8))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    loss = (L.chunked_sdpa(*ts, causal=True, block_kv=8) * _t(w)).sum()
    got = torch.autograd.grad(loss, ts)
    want = jax.grad(lambda a, b, c: jnp.sum(J.chunked_sdpa(
        a, b, c, causal=True, block_kv=8) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, jg in zip(got, want):
        _close(g, jg, atol=1e-6 * float(np.abs(np.asarray(jg)).max()))


@pytest.mark.parametrize("s", [L.CHUNK_THRESHOLD - 1, L.CHUNK_THRESHOLD])
def test_attention_on_both_sides_of_the_threshold(s):
    assert L.CHUNK_THRESHOLD == J.CHUNK_THRESHOLD == 2048
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, s, s, 4, 2, 16)
    got = L.attention(_t(q), _t(k), _t(v), causal=True)
    want = J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True)
    _close(got, want)


# -- GQA and SwiGLU --------------------------------------------------------------

def _cfgs():
    out = {a: jax_get_arch(a).smoke_config for a in LM_IDS}
    out["qwen2-1.5b-kv2"] = jax_reduced_lm(jax_get_arch("qwen2-1.5b").config,
                                           n_kv_heads=2)
    out["qwen3-32b-kv2"] = jax_reduced_lm(jax_get_arch("qwen3-32b").config,
                                          n_kv_heads=2)
    return out


CFGS = _cfgs()


def _gqa_params(cfg, seed):
    p = _perturbed(J.gqa_init(jax.random.PRNGKey(seed), cfg), seed)
    return p, {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_gqa_qkv_and_apply(name):
    cfg = CFGS[name]
    jp, tp = _gqa_params(cfg, 5)
    assert set(tp) == set(L.gqa_init(torch.Generator().manual_seed(0),
                                     cfg).keys())
    assert ("bq" in tp) == cfg.qkv_bias and ("q_norm" in tp) == cfg.qk_norm
    rng = np.random.default_rng(6)
    x = _normal(rng, (2, 13, cfg.d_model))
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13))
    for a, b in zip(L.gqa_qkv(tp, cfg, _t(x), _t(pos)),
                    J.gqa_qkv(jp, cfg, jnp.asarray(x), jnp.asarray(pos))):
        _close(a, b)
    _close(L.gqa_apply(tp, cfg, _t(x), _t(pos)),
           J.gqa_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos)))


@pytest.mark.parametrize("name", ["qwen2-1.5b-kv2", "qwen3-32b"])
def test_gqa_decode_drops_a_write_past_the_cache(name):
    """Row 0 writes inside the cache, row 1 at pos == Smax: the reference
    drops that update (JAX's out-of-bounds scatter); so must the port,
    without an index error."""
    cfg = CFGS[name]
    jp, tp = _gqa_params(cfg, 7)
    rng = np.random.default_rng(8)
    smax = 9
    ck = _normal(rng, (2, smax, cfg.n_kv_heads, cfg.head_dim))
    cv = _normal(rng, (2, smax, cfg.n_kv_heads, cfg.head_dim))
    x = _normal(rng, (2, 1, cfg.d_model))
    pos = np.array([4, smax], np.int32)
    tk, tv = _t(ck), _t(cv)
    with torch.no_grad():
        out, (gk, gv) = L.gqa_decode(tp, cfg, _t(x), _t(pos), (tk, tv),
                                     _t(pos + 1))
    want, (wk, wv) = J.gqa_decode(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                  (jnp.asarray(ck), jnp.asarray(cv)),
                                  jnp.asarray(pos + 1))
    assert gk is tk and gv is tv                      # written in place
    _close(out, want)
    _close(gk, wk)
    _close(gv, wv)
    assert np.array_equal(gk[1].numpy(), ck[1])       # row 1 dropped
    assert np.array_equal(gv[1].numpy(), cv[1])
    assert not np.array_equal(gk[0, 4].numpy(), ck[0, 4])


def test_write_rows_follows_jax_indexing():
    """In range, negative (counted from the end) and past either end."""
    rng = np.random.default_rng(9)
    cache = _normal(rng, (5, 6, 3))
    new = _normal(rng, (5, 3))
    pos = np.array([0, 5, -1, 6, -7], np.int32)
    got = _t(cache)
    L.write_rows(got, _t(pos), _t(new))
    want = jnp.asarray(cache).at[jnp.arange(5), jnp.asarray(pos)].set(
        jnp.asarray(new))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_swiglu():
    rng = np.random.default_rng(10)
    jp = _perturbed(J.swiglu_init(jax.random.PRNGKey(1), 32, 48,
                                  jnp.float32), 10)
    x = _normal(rng, (3, 5, 32))
    got = L.swiglu_apply({k: _t(v) for k, v in jp.items()}, _t(x))
    _close(got, J.swiglu_apply(jp, jnp.asarray(x)))
    tp = L.swiglu_init(torch.Generator().manual_seed(0), 32, 48,
                       torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tp.items()} == {
        "w_gate": ((32, 48), torch.bfloat16),
        "w_up": ((32, 48), torch.bfloat16),
        "w_down": ((48, 32), torch.bfloat16)}
