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
- The gradient with respect to the table (``embedding_bag_backward_ref``,
  through the op's autograd function): within rtol 1e-6 of ``jax.grad`` of
  the reference's ``_bag`` and of its oracle (XLA's scatter-add and the
  einsum's transpose sum in their own orders), with pads, all-pad bags and
  ids repeated inside and across bags; and exactly the sum, per row, of
  the terms (g[b] / denom_b) * w[b, l] in ascending (b, l) order, which is
  what the CUDA kernel adds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as \
    jax_embedding_bag_oracle
from repro.models import recsys as jax_recsys
from repro_torch.kernels.embedding_bag import embedding_bag, \
    embedding_bag_backward_ref, embedding_bag_ref
from repro_torch.models import recsys

SWEEP = [(50, 16, 6, 5), (128, 64, 16, 1), (11, 8, 3, 20)]   # v, d, b, l


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One torch intra-op thread while this module runs: the suite runs in
    several worker processes, and their OpenMP threads spinning against
    each other make many small ops several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# -- the gradient with respect to the table -----------------------------------

def _grad_inputs(v, d, b, l, seed):
    """Float table, ids with pads, bag 0 all pads, id 3 repeated inside
    bag 1 and again in bag 2; float weights and a cotangent."""
    table, ids, w = _inputs(v, d, b, l, seed)
    ids[0] = -1
    ids[1, :3] = 3
    ids[2, -1] = 3
    g = np.random.default_rng(seed + 1).standard_normal((b, d)).astype(
        np.float32)
    return table, ids, w, g


def _port_grad(table, ids, w, g, combiner):
    t = torch.from_numpy(table).requires_grad_()
    out = embedding_bag(t, torch.from_numpy(ids),
                        None if w is None else torch.from_numpy(w), combiner)
    assert type(out.grad_fn).__name__ == "EmbeddingBagFunctionBackward"
    (grad,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    return grad.numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", [(50, 16, 6, 5), (11, 8, 5, 20),
                                     (503, 32, 16, 8)])
def test_table_gradient_matches_jax_grad_of_the_reference_bag(v, d, b, l,
                                                              combiner):
    table, ids, _, g = _grad_inputs(v, d, b, l, seed=v * l)
    got = _port_grad(table, ids, None, g, combiner)
    jg, ji = jnp.asarray(g), jnp.asarray(ids)
    for fn in (lambda t: jax_recsys._bag(None, t, ji, combiner),
               lambda t: jax_embedding_bag_oracle(t, ji, None, combiner)):
        want = jax.grad(lambda t: jnp.sum(fn(t) * jg))(jnp.asarray(table))
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    untouched = np.setdiff1d(np.arange(v), ids[ids >= 0])
    assert not got[untouched].any()
    assert np.abs(got[3]).sum() > 0


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_weighted_table_gradient_matches_jax_grad_of_the_oracle(combiner):
    table, ids, w, g = _grad_inputs(60, 16, 7, 9, seed=5)
    got = _port_grad(table, ids, w, g, combiner)
    jg = jnp.asarray(g)
    want = jax.grad(lambda t: jnp.sum(jax_embedding_bag_oracle(
        t, jnp.asarray(ids), jnp.asarray(w), combiner) * jg))(
            jnp.asarray(table))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_table_gradient_adds_in_ascending_bag_order(combiner, weighted):
    """Each row is ((0 + t_0) + t_1) + ... over its members in (b, l)
    order, t = (g[b] / denom_b) * w[b, l]: the CUDA kernel's order."""
    table, ids, w, g = _grad_inputs(30, 8, 9, 12, seed=9)
    ids[4, 2] = 40                                # past the table: row 29
    w = w if weighted else None
    got = embedding_bag_backward_ref(torch.from_numpy(g),
                                     torch.from_numpy(ids),
                                     None if w is None else
                                     torch.from_numpy(w), combiner, 30)
    want = torch.zeros((30, 8))
    gt = torch.from_numpy(g)
    for b in range(ids.shape[0]):
        weights = torch.ones(ids.shape[1]) if w is None \
            else torch.from_numpy(w[b])
        denom = torch.zeros(())
        for l in range(ids.shape[1]):
            if ids[b, l] >= 0:
                denom = denom + weights[l]
        for l in range(ids.shape[1]):
            if ids[b, l] < 0:
                continue
            t = gt[b] / denom.clamp_min(1e-9) if combiner == "mean" \
                else gt[b]
            if w is not None:
                t = t * weights[l]
            row = min(int(ids[b, l]), 29)
            want[row] = want[row] + t
    assert torch.equal(got, want)


def test_gradient_of_an_all_pad_batch_is_zero():
    ids = torch.full((3, 4), -1, dtype=torch.int32)
    grad = embedding_bag_backward_ref(torch.ones(3, 5), ids, None, "mean", 7)
    assert torch.equal(grad, torch.zeros(7, 5))


def test_bf16_table_does_not_train():
    t = torch.zeros((4, 8), dtype=torch.bfloat16, requires_grad=True)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(t, ids, None, "mean")
    with torch.inference_mode():                  # serving a bf16 table
        assert embedding_bag(t, ids, None, "mean").shape == (2, 8)


def test_weights_get_no_gradient():
    t = torch.randn((6, 4), requires_grad=True)
    w = torch.rand((2, 3), requires_grad=True)
    ids = torch.tensor([[0, 1, 5], [2, -1, 2]], dtype=torch.int32)
    out = embedding_bag(t, ids, w, "sum")
    gt, gw = torch.autograd.grad(out.sum(), (t, w), allow_unused=True)
    assert gw is None and gt.shape == t.shape
