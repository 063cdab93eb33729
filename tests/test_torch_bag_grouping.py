"""The bag's grouping (``bag_grouping``: a ``BagPlan`` of the flat ids) and
the planned scatters, on the CPU with torch on one intra-op thread.

``bag_grouping_ref`` against a numpy ``argsort(kind="stable")`` grouping
(empty input, all pads, V = 1, ids >= V, a 10,000-member hub, (B, L)
bags); the planned gradient of a weighted mean bag against a numpy
float32 loop in ascending (b, l) order, bit for bit. ``segment_sum``,
``embedding_bag``'s gradient and DimeNet's forward, loss and gradients
give the same bits with plans as without, DimeNet groups once per id
array a step, and with plans they stay within the DimeNet tests'
tolerances of ``jax.ops.segment_sum`` (exact) and of the reference's
DimeNet (forward and loss rtol / atol 1e-5 of a tensor's scale, gradients
atol 4e-6 of a leaf's scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import graph_sampler as JG
from repro.models import dimenet as JD
from repro_torch.carry import gnn_params_from_jax, named_from_jax
from repro_torch.data.graph_sampler import graph_to_device
from repro_torch.kernels.embedding_bag import bag_grouping, \
    bag_grouping_cuda, bag_grouping_ref, embedding_bag, \
    embedding_bag_backward_ref, segment_sum
from repro_torch.models import dimenet as D

CPU = torch.device("cpu")
CFG = jax_get_arch("dimenet").smoke_config
RTOL, ATOL = 1e-5, 1e-5          # forward and loss, of the tensor's scale
GRAD_RTOL, GRAD_ATOL = 1e-5, 4e-6
GRAPHS = {
    "z-graphs": dict(seed=0, n_nodes=48, n_edges=96, n_triplets=256,
                     n_graphs=4),
    "x-nodes": dict(seed=1, n_nodes=40, n_edges=96, n_triplets=200,
                    d_feat=8, node_targets=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_grouping(ids, v):
    """(order, rows, starts) by numpy's stable argsort of the folded ids."""
    flat = np.minimum(np.asarray(ids).reshape(-1).astype(np.int64), v - 1)
    perm = np.argsort(flat, kind="stable")
    keys = flat[perm]
    keep = keys >= 0
    keys, perm = keys[keep], perm[keep]
    head = np.ones(len(keys), dtype=bool)
    head[1:] = keys[1:] != keys[:-1]
    starts = np.append(np.flatnonzero(head), len(keys))
    return perm, keys[head], starts


def _ids_case(name):
    rng = np.random.default_rng(len(name))
    if name == "empty":
        return np.zeros((0,), np.int32), 7
    if name == "all_pads":
        return np.full((500,), -1, np.int32), 40
    if name == "one_row":
        ids = rng.integers(-1, 3, 300).astype(np.int32)
        return ids, 1
    if name == "past_the_table":
        ids = rng.integers(-1, 60, 400).astype(np.int32)
        ids[::7] = 50 + rng.integers(0, 1000, len(ids[::7]))
        return ids, 50
    if name == "hub":
        ids = rng.integers(-1, 3000, 40_000).astype(np.int32)
        ids[rng.permutation(40_000)[:10_000]] = 5
        return ids, 3000
    if name == "bags":
        ids = rng.integers(-1, 200, (64, 12)).astype(np.int32)
        ids[3] = -1
        return ids, 200
    raise KeyError(name)


CASES = ["empty", "all_pads", "one_row", "past_the_table", "hub", "bags"]


@pytest.mark.parametrize("name", CASES)
def test_grouping_equals_a_stable_numpy_argsort(name):
    ids, v = _ids_case(name)
    plan = bag_grouping_ref(torch.from_numpy(ids), v)
    order, rows, starts = _numpy_grouping(ids, v)
    assert plan.num_rows == v and plan.ids.dtype == torch.int32
    assert np.array_equal(plan.ids.numpy(), ids.reshape(-1))
    for got in (plan.order, plan.rows, plan.starts, plan.count):
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(plan.order.numpy(), order)
    np.testing.assert_array_equal(plan.rows.numpy(), rows)
    np.testing.assert_array_equal(plan.starts.numpy(), starts)
    assert plan.count.tolist() == [len(rows), len(order)]
    used = plan.used()
    assert all(torch.equal(a, b) for a, b in zip(
        used, (plan.order, plan.rows, plan.starts)))
    # the dispatch takes the plain version for CPU ids
    again = bag_grouping(torch.from_numpy(ids), v)
    assert all(torch.equal(getattr(again, f), getattr(plan, f))
               for f in ("order", "rows", "starts", "count"))


def test_grouping_refuses_no_rows_and_the_card_backend_on_the_cpu():
    with pytest.raises(ValueError):
        bag_grouping_ref(torch.zeros(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        bag_grouping_cuda(torch.zeros(4, dtype=torch.int32), 3)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_planned_gradient_is_a_float32_loop_in_bag_order(combiner,
                                                         weighted):
    """The planned plain gradient: each row gets ((0 + t_0) + t_1) + ...
    over its members in ascending (b, l), t = (g[b] / denom_b) * w[b, l],
    as a numpy float32 loop computes it; -0.0 terms included."""
    ids, v = _ids_case("bags")
    b, l = ids.shape
    rng = np.random.default_rng(3)
    g = rng.standard_normal((b, 5)).astype(np.float32)
    g[1] = -0.0
    w = rng.random((b, l)).astype(np.float32) if weighted else None
    plan = bag_grouping_ref(torch.from_numpy(ids), v)
    got = embedding_bag_backward_ref(
        torch.from_numpy(g), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), combiner, v, plan)
    want = np.zeros((v, 5), np.float32)
    ww = np.ones((b, l), np.float32) if w is None else w
    for bi in range(b):
        den = np.float32(0)
        for li in range(l):
            den = np.float32(den + (ww[bi, li] if ids[bi, li] >= 0 else 0))
        den = max(den, np.float32(1e-9))
        for li in range(l):
            if ids[bi, li] < 0:
                continue
            t = g[bi] / den if combiner == "mean" else g[bi].copy()
            if w is not None:
                t = t * w[bi, li]
            want[ids[bi, li]] = want[ids[bi, li]] + t
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert torch.equal(got, embedding_bag_backward_ref(
        torch.from_numpy(g), torch.from_numpy(ids),
        None if w is None else torch.from_numpy(w), combiner, v))


@pytest.mark.parametrize("width", [1, 16])
def test_planned_segment_sum_matches_jax_and_the_unplanned_bits(width):
    rng = np.random.default_rng(20 + width)
    t, s = 300, 40
    data = rng.standard_normal((t, width)).astype(np.float32)
    ids = rng.integers(0, s, t).astype(np.int32)
    ids[rng.random(t) < 0.3] = -1
    ids[:50] = 7
    keep = (ids >= 0).astype(np.float32)
    want = jax.ops.segment_sum(jnp.asarray(data * keep[:, None]),
                               jnp.asarray(np.maximum(ids, 0)),
                               num_segments=s)
    tids = torch.from_numpy(ids)
    plan = bag_grouping(tids, s)
    td = torch.from_numpy(data).requires_grad_(True)
    got = segment_sum(td, tids, s, plan)
    assert np.array_equal(got.detach().numpy(), np.asarray(want))
    bare = segment_sum(td, tids, s)
    assert torch.equal(got.detach().view(torch.int32),
                       bare.detach().view(torch.int32))
    cot = torch.from_numpy(rng.standard_normal((s, width)).astype(
        np.float32))
    (g1,) = torch.autograd.grad(got, td, cot)
    (g2,) = torch.autograd.grad(bare, td, cot)
    assert torch.equal(g1, g2)
    with pytest.raises(ValueError, match="plan"):
        segment_sum(td, tids, s + 1, plan)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_planned_bag_gradient_equals_the_unplanned_bits(combiner):
    ids, v = _ids_case("bags")
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((v, 6)).astype(np.float32))
    w = torch.from_numpy(rng.random(ids.shape).astype(np.float32))
    tids = torch.from_numpy(ids)
    cot = torch.from_numpy(rng.standard_normal((ids.shape[0], 6)).astype(
        np.float32))
    grads = []
    for plan in (bag_grouping(tids, v), None):
        t = table.clone().requires_grad_(True)
        out = embedding_bag(t, tids, w, combiner, plan=plan)
        grads.append(torch.autograd.grad(out, t, cot)[0])
    assert torch.equal(grads[0].view(torch.int32), grads[1].view(torch.int32))
    with pytest.raises(ValueError, match="plan"):
        embedding_bag(table, tids[:-1], None, combiner,
                      plan=bag_grouping(tids, v))


@pytest.fixture(scope="module")
def dimenet_cases():
    """Per graph: the numpy batch, the reference's params, the port's
    model over them, the reference's (forward, loss, grads)."""
    out = {}
    for i, (name, kw) in enumerate(GRAPHS.items()):
        g = JG.make_dimenet_batch(**kw)
        jp = JD.init_params(jax.random.PRNGKey(30 + i), CFG,
                            kw.get("d_feat", 0))
        jgraph = {k: jnp.asarray(v) for k, v in g.items()}

        def ref(p, gr):
            fwd = JD.forward(p, CFG, gr)
            (loss, _), grads = jax.value_and_grad(JD.loss_fn, has_aux=True)(
                p, CFG, gr)
            return fwd, loss, grads
        fwd, loss, grads = jax.jit(ref)(jp, jgraph)
        out[name] = dict(g=g, model=gnn_params_from_jax(jp, CFG, CPU),
                         fwd=fwd, loss=loss, grads=grads)
    return out


def _close(got, want, rtol, atol, **kw):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=rtol, atol=atol * scale, **kw)


def _run(model, graph):
    graph_out, node_out = D.forward(model, CFG, graph)
    loss, _ = D.loss_fn(model, CFG, graph)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return [graph_out.detach(), node_out.detach(), loss.detach(), *grads]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_dimenet_groups_once_per_id_array_and_plans_change_no_bit(
        dimenet_cases, name, monkeypatch):
    c = dimenet_cases[name]
    graph = graph_to_device(c["g"], CPU)
    built = []

    def counted(ids, rows):
        built.append(rows)
        return bag_grouping(ids, rows)
    monkeypatch.setattr(D, "bag_grouping", counted)
    planned = _run(c["model"], graph)
    # forward and loss_fn each plan src, dst, t_kj, t_ji; the one call
    # each on a molecule batch's z and graph ids groups inside the call
    assert len(built) == 2 * 4
    monkeypatch.setattr(D, "bag_grouping", lambda ids, rows: None)
    bare = _run(c["model"], graph)
    for a, b in zip(planned, bare):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", list(GRAPHS))
def test_planned_dimenet_matches_the_reference(dimenet_cases, name):
    c = dimenet_cases[name]
    got = _run(c["model"], graph_to_device(c["g"], CPU))
    _close(got[0], c["fwd"][0], RTOL, ATOL)
    _close(got[1], c["fwd"][1], RTOL, ATOL)
    _close(got[2], c["loss"], RTOL, ATOL)
    want = named_from_jax(c["grads"], CPU)
    names = [n for n, _ in c["model"].named_parameters()]
    assert set(names) == set(want)
    for n, g in zip(names, got[3:]):
        _close(g, want[n], GRAD_RTOL, GRAD_ATOL, err_msg=n)


def test_chip_smoke_step_launches_count_the_groupings(monkeypatch):
    """chip_smoke.gnn_step_launches: 20 gathers, 20 scatters and 4
    groupings a step at the published 6 blocks (22, 22, 6 on a molecule
    batch of several graphs); its grouping count is the number of
    groupings a SMOKE forward and backward make."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    full = jax_get_arch("dimenet").config
    hosts = {name: JG.make_dimenet_batch(**kw) for name, kw in GRAPHS.items()}
    assert smoke.gnn_step_launches(full, hosts["x-nodes"]) == {
        "embedding_bag": 20, "embedding_bag_backward": 20,
        "bag_grouping": 4}
    assert smoke.gnn_step_launches(full, hosts["z-graphs"]) == {
        "embedding_bag": 22, "embedding_bag_backward": 22,
        "bag_grouping": 6}
    from repro_torch.kernels.embedding_bag import ops, ref
    built = []

    def counted(ids, rows):
        built.append(rows)
        return bag_grouping_ref(ids, rows)
    monkeypatch.setattr(ops, "bag_grouping_ref", counted)
    monkeypatch.setattr(ref, "bag_grouping_ref", counted)
    for name, host in hosts.items():
        built.clear()
        model = D.init_params(torch.Generator().manual_seed(0), CFG,
                              host["x"].shape[1] if "x" in host else 0)
        graph_out, node_out = D.forward(model, CFG,
                                        graph_to_device(host, CPU))
        (graph_out.sum() + node_out.sum()).backward()
        assert len(built) == smoke.gnn_step_launches(CFG, host)[
            "bag_grouping"], name
