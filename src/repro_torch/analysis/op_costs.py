"""Per-op cost counting of one eager run: the port's counterpart of the
reference's ``analysis/hlo.py`` and ``analysis/hlo_costs.py``.

The reference lowers and compiles each step with XLA and parses the
optimized HLO text for dot FLOPs, HBM bytes and collectives. The port runs
eagerly: there is no compiled module to parse, so the counter watches the
run itself. ``CostCounter`` is a ``TorchDispatchMode``: every ATen op the
step dispatches passes through it once, on any device, the ``meta`` device
included, where tensors have shapes and no storage and nothing is
allocated (``launch/dryrun.py`` runs the production cells so). Per op it
records:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (products, attention),
    plus one FLOP per input element of a reduction, as ``hlo_costs``
    counts a ``reduce``; filed under the dtype the op ran in ("bf16",
    "f32", "tf32" for a float32 product with TF32 allowed, ...), which
    ``roofline`` prices at that dtype's peak;
  * bytes: operands plus results. Views and other aliasing outputs are
    free, as ``hlo_costs._SKIP_BYTES_OPS`` makes them; a gather
    (``index``, ``index_select``, ``gather``, ``embedding``) reads the
    gathered rows and its indices, not the whole operand, and a scatter
    (``index_put_``, ``index_add_``, ``scatter_add_`` ...) the update and
    its indices, as ``hlo_costs._local_costs`` prices gathers and
    scatters;
  * counts by op name; ``top_ops(n)`` gives the largest by FLOPs or bytes
    (``hlo_costs.top_dots`` / ``top_bytes``).

The hand-written kernels are ctypes calls that ATen never sees: each
kernel wrapper calls ``record_kernel`` with its kernel's FLOPs and bytes,
from one cost function per kernel that the card branch and the meta branch
both call.

Devices. The port drives a mesh from one process; ``distributed.sharding``
runs each (group, shard) program inside ``in_shard``, so its ops, and the
backward ops autograd records for them, are counted for that device apart.
The merges between a shard and the merge device are priced as the
reference's collectives (``record_collective``: all-gather, all-reduce,
with ``hlo.py``'s per-device wire factors) and their own ops are not
counted. Work on rows the reference splits over n devices (a recsys
table, its row accumulator, its gradient) is counted in a bucket of its
own, divided by n: ``in_split`` runs a function so (``sharding.
put_row_sharded``'s split, whose backward assembles the table's
gradient), ``place`` names such a tensor, and an op outside every shard
and ``in_split`` whose largest operand lies on a placed storage, or on
one that such work allocated, is counted there too (the optimizer's
update of the table). Per device, the counter gives the busiest (group,
shard) program's costs, plus each split bucket over its n, plus the rest
divided by ``outside_split`` (1: every device runs it, as nodes
replicated over an edge partition; the batch axes' size for a batch the
reference splits over them). The
bucket of n = 1 is work every device does once: a train step's
gradients' all-reduce (``launch/specs.py``) is recorded there.

One difference from the reference in what is counted: ``hlo_costs``
multiplies a while body by its ``known_trip_count``; an eager loop
dispatches every trip and is counted on every trip.

Memory: every op result on a storage no operand has is a new allocation.
The storage stays live while any tensor on it does: the results and views
on it, and the tensors autograd saves for the backward pass (a
``saved_tensors_hooks`` pair holds those). The counter keeps the live
bytes per bucket and their peak per device, ``temp_bytes`` in the
dry-run record.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

_FREE = {aten.detach, aten.lift_fresh, aten.empty, aten.empty_strided,
         aten.empty_like, aten.new_empty, aten.new_empty_strided,
         aten._local_scalar_dense, aten.set_, aten.resize_, aten.alias,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.is_same_size,
         aten._unsafe_view}    # _unsafe_view: a view the schema does not mark
_GATHER = {aten.index, aten.index_select, aten.gather, aten.embedding,
           aten.take, aten._unsafe_index}
_SCATTER = {aten.index_put_, aten.index_put, aten._index_put_impl_,
            aten.index_add, aten.index_add_, aten.index_copy,
            aten.index_copy_, aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.scatter_reduce, aten.scatter_reduce_,
            aten.index_fill_, aten.index_fill, aten.masked_scatter_,
            aten.embedding_dense_backward}
_REDUCE = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
           aten.prod, aten.norm, aten.linalg_vector_norm, aten.var,
           aten.std, aten.var_mean, aten.logsumexp, aten.argmax,
           aten.argmin, aten.cumsum, aten.any, aten.all}
_SOFTMAX = {aten._softmax, aten._log_softmax}     # a max and a sum
_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}

_DTYPE_NAME = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64"}

_STACK: List["CostCounter"] = []


def active() -> Optional["CostCounter"]:
    """The innermost counter in force, or None."""
    return _STACK[-1] if _STACK else None


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flat_tensors(items) -> List[torch.Tensor]:
    """The tensors among ``items`` and one level of lists inside them (an
    op's arguments: ``cat``'s list, ``index``'s optional indices)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


_INFO: dict = {}


def _op_info(func):
    """(name, kind, flop formula or None) of an OpOverload, cached."""
    packet = func._overloadpacket
    returns = func._schema.returns
    if packet in _FREE or all(r.alias_info is not None
                              and not r.alias_info.is_write
                              for r in returns) and returns:
        kind = "free"
    elif packet not in flop_registry and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"):
        kind = "composite"
    elif packet in _GATHER:
        kind = "gather"
    elif packet in _SCATTER:
        kind = "scatter"
    elif packet in _REDUCE:
        kind = "reduce"
    elif packet in _SOFTMAX:
        kind = "softmax"
    else:
        kind = "plain"
    info = (str(packet).replace("aten.", ""), kind,
            flop_registry.get(packet))
    _INFO[func] = info
    return info


def _flop_dtype(tensors, packet) -> str:
    for t in tensors:
        if t.is_floating_point():
            name = _DTYPE_NAME.get(t.dtype, "f32")
            if name == "f32" and packet in _MATMUL and \
                    torch.backends.cuda.matmul.allow_tf32:
                return "tf32"
            return name
    return "int"


@dataclass
class DeviceCosts:
    """One device's (or a bucket's) costs."""
    flops: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    bytes: float = 0.0
    link_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    op_counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    op_flops: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    op_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def add(self, name: str, flops: float, dtype: str, nbytes: float):
        self.op_counts[name] += 1
        if flops:
            self.flops[dtype] += flops
            self.op_flops[name] += flops
        self.bytes += nbytes
        self.op_bytes[name] += nbytes

    def scaled(self, s: float) -> "DeviceCosts":
        out = DeviceCosts()
        for k, v in self.flops.items():
            out.flops[k] = v * s
        out.bytes, out.link_bytes = self.bytes * s, self.link_bytes * s
        for k, v in self.op_flops.items():
            out.op_flops[k] = v * s
        for k, v in self.op_bytes.items():
            out.op_bytes[k] = v * s
        out.op_counts.update(self.op_counts)
        out.collective_counts.update(self.collective_counts)
        return out

    def merged(self, other: "DeviceCosts") -> "DeviceCosts":
        out = self.scaled(1.0)
        for k, v in other.flops.items():
            out.flops[k] += v
        out.bytes += other.bytes
        out.link_bytes += other.link_bytes
        for src, dst in ((other.op_flops, out.op_flops),
                         (other.op_bytes, out.op_bytes),
                         (other.op_counts, out.op_counts),
                         (other.collective_counts, out.collective_counts)):
            for k, v in src.items():
                dst[k] += v
        return out

    def top_ops(self, n: int = 12, by: str = "flops"
                ) -> List[Tuple[str, float, int]]:
        """(op, FLOPs or bytes, calls), largest first."""
        src = self.op_flops if by == "flops" else self.op_bytes
        rows = sorted(src.items(), key=lambda kv: -kv[1])[:n]
        return [(k, v, self.op_counts[k]) for k, v in rows]


def wire_bytes(op: str, nbytes: float, participants: int) -> float:
    """Per-device bytes on the links of one ring collective whose result is
    ``nbytes`` (the reference's ``analysis/hlo.py`` factors)."""
    p = max(int(participants), 1)
    if op == "all-reduce":
        return nbytes * 2.0 * (p - 1) / p
    if op == "reduce-scatter":
        return nbytes * (p - 1)
    if op == "collective-permute":
        return nbytes
    return nbytes * (p - 1) / p          # all-gather, all-to-all


class CostCounter(TorchDispatchMode):
    """Count one run's ATen ops and kernel launches (module docstring).

        with CostCounter(outside_split=16) as c:
            step(...)
        c.per_device()      # DeviceCosts of the busiest device
    """

    def __init__(self, outside_split: int = 1):
        super().__init__()
        self.outside_split = max(int(outside_split), 1)
        self.common = DeviceCosts()
        self.shards: Dict[tuple, DeviceCosts] = defaultdict(DeviceCosts)
        # work on rows split over n devices, by n (module docstring)
        self.splits: Dict[int, DeviceCosts] = defaultdict(DeviceCosts)
        self.key: Optional[tuple] = None
        self.split: Optional[int] = None          # inside ``in_split``
        self._placed: Dict[int, int] = {}         # storage -> n
        self.scale = 1.0               # > 1 inside ``loop``'s counted trip
        self._suspended = 0
        self._live_common = 0
        self._live_shard: Dict[tuple, int] = defaultdict(int)
        self._live_split: Dict[int, int] = defaultdict(int)
        # storage -> [holders, bytes, bucket]: a storage is live while
        # any tensor on it (a result, a view, a tensor autograd saved) is;
        # a bucket is None (common), a shard key or a split's n
        self._storages: Dict[int, list] = {}
        self._saved_hooks = None
        self.peak_bytes = 0.0          # per device, outside ÷ outside_split

    # -- context --------------------------------------------------------
    def __enter__(self):
        _STACK.append(self)
        if self._saved_hooks is None:
            # a saved tensor holds its storage until the graph lets it
            # go; autograd may keep it under a tensor no op returns, so
            # it is saved as a detached alias, which the mode sees
            self._saved_hooks = torch.autograd.graph.saved_tensors_hooks(
                torch.Tensor.detach, _unpacked)
            self._saved_hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        if self._saved_hooks is not None and self not in _STACK:
            self._saved_hooks.__exit__(*exc)
            self._saved_hooks = None
        return super().__exit__(*exc)

    def _scope(self):
        """The bucket the current context names: the shard program's,
        else ``in_split``'s, else None (the common work)."""
        return self.key if self.key is not None else self.split

    def _costs(self, where) -> DeviceCosts:
        if where is None:
            return self.common
        if isinstance(where, int):
            return self.splits[where]
        return self.shards[where]

    def _bucket(self) -> DeviceCosts:
        return self._costs(self._scope())

    def _split_of(self, t: torch.Tensor) -> Optional[int]:
        cd = t.untyped_storage()._cdata
        n = self._placed.get(cd)
        if n is None:
            ent = self._storages.get(cd)
            if ent is not None and isinstance(ent[2], int):
                n = ent[2]
        return n

    def _where(self, ins: List[torch.Tensor]):
        """An op's bucket: the context's, else its largest operand's
        split, else the common work."""
        where = self._scope()
        if where is None and ins and (self._placed or self._live_split):
            where = self._split_of(max(ins, key=torch.Tensor.numel))
        return where

    def place(self, t: torch.Tensor, n: int) -> None:
        """``t``'s rows are split over ``n`` devices: work on it is counted
        per device over n (module docstring)."""
        self._placed[t.untyped_storage()._cdata] = int(n)

    @contextlib.contextmanager
    def suspended(self):
        """Count no op inside (a merge priced as a collective); new
        tensors are still tracked as live memory."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- memory ---------------------------------------------------------
    def _note_peak(self):
        own = self._live_shard[self.key] if self.key is not None else (
            max(self._live_shard.values()) if self._live_shard else 0)
        cur = self._live_common / self.outside_split + own + sum(
            v / n for n, v in self._live_split.items())
        if cur > self.peak_bytes:
            self.peak_bytes = cur

    def _live(self, where, nbytes: int):
        if where is None:
            self._live_common += nbytes
        elif isinstance(where, int):
            self._live_split[where] += nbytes
        else:
            self._live_shard[where] += nbytes

    def _hold(self, t: torch.Tensor, new: bool, where=None):
        """One more holder of ``t``'s storage (a new allocation in bucket
        ``where`` when ``new``; an alias of a tracked one otherwise),
        released when ``t`` dies."""
        cd = t.untyped_storage()._cdata
        ent = self._storages.get(cd)
        if ent is None:
            if not new:
                return                     # on a storage from before the run
            ent = self._storages[cd] = [0, t.untyped_storage().nbytes(),
                                        where]
            self._live(where, ent[1])
            self._note_peak()
        ent[0] += 1
        weakref.finalize(t, self._release, cd)

    def _release(self, cd: int):
        ent = self._storages.get(cd)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            del self._storages[cd]
            self._live(ent[2], -ent[1])

    # -- recording ------------------------------------------------------
    def record(self, name: str, flops: float, nbytes: float,
               dtype: str = "f32"):
        """A hand-written kernel's (or any named piece of work's) cost."""
        if not self._suspended:
            self._bucket().add(name, flops * self.scale, dtype,
                               nbytes * self.scale)

    def record_collective(self, op: str, nbytes: float, participants: int):
        """A merge priced as the reference's collective over
        ``participants`` devices (``nbytes``: its full result)."""
        if participants <= 1:
            return
        b = self._bucket()
        b.link_bytes += wire_bytes(op, nbytes, participants) * self.scale
        b.collective_counts[op] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = _INFO.get(func) or _op_info(func)
        name, kind, flop_fn = info
        if kind == "composite":
            # an op that reaches the mode whole (``matmul`` under
            # inference mode): count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _flat_tensors(args)
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        res = [out] if isinstance(out, torch.Tensor) else \
            _flat_tensors(out if isinstance(out, (tuple, list)) else ())
        where = self._where(ins)
        if res:
            # a result on a storage no input has is a new allocation; one
            # on an input's storage (a view, detach) holds that storage
            have = {t.untyped_storage()._cdata for t in ins}
            for o in res:
                key = o.untyped_storage()._cdata
                self._hold(o, key not in have, where)
                have.add(key)
        if self._suspended:
            return out
        flops = 0.0
        dtype = "f32"
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
            dtype = _flop_dtype(ins, func._overloadpacket)
        elif kind in ("reduce", "softmax") and ins:
            flops = ins[0].numel() * (2.0 if kind == "softmax" else 1.0)
            dtype = _flop_dtype(ins, None)
        if kind == "free":
            nbytes = 0
        else:
            rb = sum(tensor_bytes(t) for t in res)
            if kind == "gather":
                nbytes = sum(tensor_bytes(t) for t in ins[1:]) + 2 * rb
            elif kind == "scatter":
                nbytes = sum(tensor_bytes(t) for t in ins[1:])
            else:
                nbytes = sum(tensor_bytes(t) for t in ins) + rb
        self._costs(where).add(name, flops * self.scale, dtype,
                               nbytes * self.scale)
        return out

    # -- results --------------------------------------------------------
    def busiest_shard(self) -> DeviceCosts:
        if not self.shards:
            return DeviceCosts()
        return max(self.shards.values(),
                   key=lambda c: (c.total_flops, c.bytes, c.link_bytes))

    def per_device(self) -> DeviceCosts:
        """The busiest device: its (group, shard) programs, plus each split
        bucket over its n, plus the rest over ``outside_split``."""
        out = self.busiest_shard().merged(
            self.common.scaled(1.0 / self.outside_split))
        for n, c in sorted(self.splits.items()):
            out = out.merged(c.scaled(1.0 / n))
        return out


def record_kernel(name: str, flops: float, nbytes: float,
                  dtype: str = "f32") -> None:
    """File a hand-written kernel's FLOPs and bytes with the counter in
    force (a no-op without one)."""
    c = active()
    if c is not None:
        c.record(name, flops, nbytes, dtype)


def record_collective(op: str, nbytes: float, participants: int) -> None:
    c = active()
    if c is not None:
        c.record_collective(op, nbytes, participants)


@contextlib.contextmanager
def suspended():
    """Count no op inside (a no-op without a counter)."""
    c = active()
    if c is None:
        yield
        return
    with c.suspended():
        yield


@contextlib.contextmanager
def loop(trips: int, *tensors: torch.Tensor):
    """Yield how many of ``trips`` identical loop trips to run: all of
    them, except on the ``meta`` device under a counter, where one trip
    is run and counted ``trips`` times (every trip has the same shapes, so
    the same ops), as ``hlo_costs`` multiplies a loop body by its trip
    count."""
    c = active()
    if c is None or trips <= 1 or not all(t.is_meta for t in tensors):
        yield trips
        return
    prev, c.scale = c.scale, c.scale * trips
    try:
        yield 1
    finally:
        c.scale = prev


def _unpacked(t: torch.Tensor) -> torch.Tensor:
    return t


class _StandIn(torch.autograd.Function):
    """``x`` repeated along ``dim``, uncounted both ways."""

    @staticmethod
    def forward(ctx, x, copies: int, dim: int):
        ctx.n, ctx.dim = x.shape[dim], dim
        with suspended():
            return torch.cat([x] * copies, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, 0, ctx.n), None, None


def stand_in(x: torch.Tensor, copies: int, dim: int = 0) -> torch.Tensor:
    """The merged result of ``copies`` identical device programs of which
    only the first ran (a meta mesh): ``x`` repeated along ``dim``. Its
    backward hands the first copy's gradient to ``x``, as each device's
    program receives its own; neither way is counted."""
    if copies == 1:
        return x
    return _StandIn.apply(x, copies, dim)


_PROBE = None


def _seq_now() -> int:
    """The autograd sequence number the next node will take."""
    global _PROBE
    if _PROBE is None:
        _PROBE = torch.zeros((), requires_grad=True)
    with suspended(), torch.enable_grad():
        return (_PROBE * 1.0).grad_fn._sequence_nr() + 1


def _hook_backward(counter: CostCounter, attr: str, value, outputs,
                   first: int, last: int) -> None:
    """Run the backward nodes that a forward recorded (sequence numbers in
    [first, last)) with ``counter.<attr>`` set to ``value`` (a shard's
    key, a split's n)."""
    def pre(*_):
        if active() is counter:
            setattr(counter, attr, value)

    def post(*_):
        if active() is counter:
            setattr(counter, attr, None)

    seen, todo = set(), [t.grad_fn for t in _tensors(outputs)
                         if t.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if first <= node._sequence_nr() < last:
            node.register_prehook(pre)
            node.register_hook(post)
            todo.extend(nxt for nxt, _ in node.next_functions)


def in_shard(key: tuple, fn, *args):
    """``fn(*args)`` counted as device ``key``'s work ((group, shard)),
    and so are the backward ops autograd records for it."""
    c = active()
    if c is None:
        return fn(*args)
    track = torch.is_grad_enabled()
    first = _seq_now() if track else 0
    prev, c.key = c.key, key
    try:
        out = fn(*args)
    finally:
        c.key = prev
    if track:
        _hook_backward(c, "key", key, out, first, _seq_now())
    return out


def in_split(n: int, fn, *args):
    """``fn(*args)`` counted as work on rows split over ``n`` devices, and
    so are the backward ops autograd records for it."""
    c = active()
    if c is None:
        return fn(*args)
    track = torch.is_grad_enabled()
    first = _seq_now() if track else 0
    prev, c.split = c.split, int(n)
    try:
        out = fn(*args)
    finally:
        c.split = prev
    if track:
        _hook_backward(c, "split", int(n), out, first, _seq_now())
    return out
