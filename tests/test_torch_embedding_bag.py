"""The port's ``embedding_bag`` (its plain version, which the CPU runs)
against the reference's, and the port's ``_bag`` against the reference's.

Inputs come from numpy seeds and go to both packages. The reference is run
both ways: ``backend="pallas"`` (its TPU kernel, in interpret mode on the
CPU) and ``backend="jnp"`` (its take + einsum oracle).

- Unit weights (the models' only case): exactly equal to the Pallas kernel,
  the oracle and ``recsys._bag``.
- Float weights: within rtol 1e-6. On the CPU, XLA contracts the Pallas
  kernel's ``acc + w * row`` into one fused multiply-add, which the port
  reproduces by rounding the float64 sum once, with its TwoSum error
  deciding a float32 midpoint; the oracle's einsum sums in another order.
  The count of elements that differ at all is printed (``pytest -s``).
- A weighted sum whose float64 sum lands exactly on a float32 midpoint
  while the exact sum lies past it: exactly equal to the Pallas kernel and
  the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.models import recsys as jax_recsys
from repro_torch.kernels.embedding_bag import embedding_bag, \
    embedding_bag_ref
from repro_torch.models import recsys

SWEEP = [(50, 16, 6, 5), (128, 64, 16, 1), (11, 8, 3, 20)]   # v, d, b, l


def _inputs(v, d, b, l, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(-1, v, (b, l)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (b, l)).astype(np.float32)
    return table, ids, w


def _reference(table, ids, w, combiner):
    """(pallas interpret, jnp oracle) outputs as numpy."""
    t, i = jnp.asarray(table), jnp.asarray(ids)
    wj = None if w is None else jnp.asarray(w)
    return tuple(np.asarray(jax_embedding_bag(t, i, wj, combiner,
                                              backend=be))
                 for be in ("pallas", "jnp"))


def _port(table, ids, w, combiner):
    tw = None if w is None else torch.from_numpy(w)
    return embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), tw,
                         combiner).numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", SWEEP)
def test_unit_weights_bit_equal_to_the_reference(v, d, b, l, combiner):
    table, ids, _ = _inputs(v, d, b, l, seed=v + l)
    got = _port(table, ids, None, combiner)
    pallas, oracle = _reference(table, ids, None, combiner)
    assert got.dtype == np.float32 and got.shape == (b, d)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", SWEEP)
def test_float_weights_match_the_reference(v, d, b, l, combiner):
    """Random float weights: within rtol 1e-6 of both forms of the
    reference (the oracle's einsum sums in another order than the fma
    chain); the single-rounding case is pinned exactly below."""
    table, ids, w = _inputs(v, d, b, l, seed=v + l)
    got = _port(table, ids, w, combiner)
    for name, want in zip(("pallas", "jnp"),
                          _reference(table, ids, w, combiner)):
        n_diff = int((got != want).sum())
        print(f"{combiner} {(v, d, b, l)} vs {name}: {n_diff} of "
              f"{got.size} elements differ")
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# (table, ids, weights) whose float64 sum 1 + 2^-24 is a float32 midpoint
# while the exact sum, 1 + 2^-24 + 7 * 2^-71, lies above it: an fma rounds
# up to 0x3F800001, a float64 sum rounded again to float32 ties to even,
# 0x3F800000. The second bag is its negative (rounds to 0xBF800001).
MIDPOINT_CASE = (np.array([[1.0], [16773185 * 2.0 ** -48]], np.float32),
                 np.array([[0, 1], [0, 1]], np.int32),
                 np.array([[1.0, 8390624 * 2.0 ** -23],
                           [-1.0, -8390624 * 2.0 ** -23]], np.float32))


def test_weighted_sum_rounds_once_as_the_reference():
    table, ids, w = MIDPOINT_CASE
    got = _port(table, ids, w, "sum")
    assert got.view(np.uint32)[:, 0].tolist() == [0x3F800001, 0xBF800001]
    for want in _reference(table, ids, w, "sum"):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_unit_weights_keep_the_float64_sum_bits(table_dtype):
    """With unit weights every step adds two float32 values, whose float64
    sum is never a float32 midpoint short of the exact sum: the single
    rounding gives the bits of the float64 sum rounded to float32."""
    table, ids, _ = _inputs(300, 24, 40, 16, seed=17)
    t = torch.from_numpy(table * 1e3).to(table_dtype)
    i = torch.from_numpy(ids)
    acc = torch.zeros((40, 24), dtype=torch.float32)
    for l in range(16):
        row = t[i[:, l].clamp_min(0).long()].double()
        acc = (acc.double() + (i[:, l, None] >= 0).double() * row).float()
    assert torch.equal(embedding_bag_ref(t, i, None, "sum"), acc)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_all_pad_row_is_zero(combiner, weighted):
    table, ids, w = _inputs(10, 4, 3, 6, seed=3)
    ids[1] = -1
    got = _port(table, ids, w if weighted else None, combiner)
    pallas, oracle = _reference(table, ids, w if weighted else None,
                                combiner)
    assert (got[1] == 0).all()
    np.testing.assert_array_equal(got[1], pallas[1])
    if not weighted:
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_bf16_table_widened_like_the_reference(combiner):
    table, ids, _ = _inputs(64, 32, 8, 12, seed=5)
    t_port = torch.from_numpy(table).to(torch.bfloat16)
    t_ref = jnp.asarray(table).astype(jnp.bfloat16)
    np.testing.assert_array_equal(t_port.float().numpy(),
                                  np.asarray(t_ref.astype(jnp.float32)))
    got = embedding_bag(t_port, torch.from_numpy(ids), None,
                        combiner).numpy()
    for be in ("pallas", "jnp"):
        want = np.asarray(jax_embedding_bag(t_ref, jnp.asarray(ids), None,
                                            combiner, backend=be))
        np.testing.assert_array_equal(got, want)


def test_ids_beyond_the_table_read_the_last_row():
    table, ids, _ = _inputs(10, 4, 2, 3, seed=7)
    ids[0] = [12, 9, -1]
    got = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids))
    want = table[9] + table[9]
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_unknown_combiner_raises():
    with pytest.raises(ValueError, match="combiner"):
        embedding_bag_ref(torch.zeros(3, 2), torch.zeros(1, 1,
                                                         dtype=torch.int32),
                          combiner="max")


@pytest.mark.parametrize("combiner", ["mean", "sum"])
@pytest.mark.parametrize("v,d,b,l", [(503, 32, 16, 8), (1000, 256, 64, 32)])
def test_bag_equals_the_reference_models_bag(v, d, b, l, combiner):
    """recsys._bag (port: the embedding_bag op) == recsys._bag (reference:
    take + masked sum), bit for bit, on float data with pads."""
    table, ids, _ = _inputs(v, d, b, l, seed=d)
    ids[0] = -1
    got = recsys._bag(None, torch.from_numpy(table), torch.from_numpy(ids),
                      combiner).numpy()
    want = np.asarray(jax_recsys._bag(None, jnp.asarray(table),
                                      jnp.asarray(ids), combiner))
    np.testing.assert_array_equal(got, want)


def test_lookup_fn_is_not_ported():
    """The lookup hook, refused before the row-sharded lookup was ported,
    now serves the bag: through a lookup_fn it takes the reference's form
    (a take and a masked mean), equal to the embedding_bag op's result on
    integer rows, pads and an all-pad bag included."""
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([[0, 5, -1], [-1, -1, -1], [2, 2, 3]],
                       dtype=torch.int32)
    for combiner in ("sum", "mean"):
        got = recsys._bag(lambda t, i: t[i], table, ids, combiner)
        assert torch.equal(got, recsys._bag(None, table, ids, combiner))
