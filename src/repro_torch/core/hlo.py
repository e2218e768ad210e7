"""Cost front end of the port: trace a torch program into the machine-level
cost model the simulator replays (port of ``repro/core/hlo.py``).

The records ``CollectiveRecord``, ``TraceOp`` and ``HloCost`` are copies
of the reference's.  What fills them differs: the reference parses the
post-optimisation XLA HLO text of a compiled program; here ``analyze(fn,
*args, **kwargs)`` runs ``fn`` under a ``TorchDispatchMode`` and emits
one compute ``TraceOp`` per aten op that does work, in program order
(named by the op, e.g. ``aten.mm.default``):

* FLOPs: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``mv``, ``dot``, ``convolution`` and its backward; ``matmul``,
  ``einsum`` and ``linear`` reach these) exactly from shapes, 2 M N K a
  product (a fused bias add is not counted, as XLA fuses it into the
  dot); every other op one FLOP per output element, as the reference
  counts elementwise ops and reductions.
* HBM bytes: operand and output bytes of each op that moves data, a
  stride-0 (broadcast) dimension read once.  View and metadata ops
  (``view``, ``expand``, ``permute``, ``transpose``, ``slice``,
  ``select``, ``unbind``, ``detach``, ``alias``, ``as_strided``, ...)
  and allocations are free, as the reference's ``_FREE_OPS``.  Eager
  PyTorch does not fuse, so these bytes exceed the reference's
  fusion-boundary bytes for the same program.
* Loops: eager PyTorch unrolls every loop, so every ``repeat`` is 1;
  the reference's trip-count scaling (``hlo.py:333``) has no
  counterpart.
* The hand-written kernels are launched through ctypes, where a
  dispatch mode does not see them.  With the inputs on the ``meta``
  device, each ``kernels.ops`` entry point (and each of its autograd
  Functions' backwards) records one ``TraceOp`` named after the kernel
  (``flash_attention``, ``rmsnorm_bwd``, ...), with the operations and
  bytes of ``kernels.cost`` (the formulas of ``chip_smoke.py``'s
  bounds), and returns empty meta outputs: the trace describes the
  program the card runs.  CPU tensors run the kernels' plain versions,
  which trace as aten ops; CUDA tensors raise (trace on ``meta``).
* Collectives: ``record_collective`` (called by ``patterns/mesh.py``'s
  collectives inside ``analyze``) and DTensor's functional collectives
  (``_c10d_functional.*``, ``_dtensor.shard_dim_alltoall``, which the
  tracer sees once it hands DTensor ops back to DTensor to desugar into
  local ops) each add a ``CollectiveRecord`` and a ``TraceOp("collective",
  ...)``, in the reference's conventions: ``payload_bytes`` the operand
  bytes of one device (the output bytes for ``all-gather``), groups the
  whole mesh, or the sorted members of a permute's pairs as one group
  (``repro/core/hlo.py:441-452``).
* One device's program: a D-mode program holds every shard's ops.  Its
  shards carry a tag (``tag``, an attribute set by ``Mesh.shard`` /
  ``replicate`` on ``meta``); an op's outputs take its operands' shard, and each op goes
  to that shard's trace (``HloCost.shards``).  The trace handed to the
  simulator is shard 0's, the collectives in program order included, as
  the reference's HLO is one device's SPMD program.  An op whose operands
  carry no shard (a constant made from host data) goes to no device and
  is counted in ``HloCost.unattributed``; an op that mixes two shards
  raises.  ``asymmetric_shards`` lists the shards whose trace differs
  from shard 0's.  A U-mode trace (``patterns/unified.py``) tags rank 0's
  local tensors as shard 0, so DTensor's own work on placeholders (its
  sharding propagation) stays off the trace, among the unattributed ops.
  A program with no tagged input (one device) traces whole.

On ``meta`` a program allocates nothing, so a full-size model traces on
a host without its weights.  ``cost_analysis(cost)`` hands
``roofline.build_terms`` the tracer's own counts in place of XLA's
``compiled.cost_analysis()`` (the reference's
``compat.cost_analysis_dict``, which reads a compiled XLA object).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import typing

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    op_name: str
    payload_bytes: int          # B convention per topology.collective_time_s
    operand_bytes: int
    output_bytes: int
    groups: typing.List[typing.List[int]]
    count: float = 1.0          # scaled by while trip counts

    @property
    def group_size(self) -> int:
        return len(self.groups[0]) if self.groups else 1


@dataclasses.dataclass
class TraceOp:
    """One entry in the device-level op trace (program order)."""
    kind: str                   # 'compute' | 'collective'
    name: str
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective: CollectiveRecord = None
    repeat: float = 1.0         # how many times this op executes (trip counts)


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: typing.List[CollectiveRecord] = dataclasses.field(default_factory=list)
    trace: typing.List[TraceOp] = dataclasses.field(default_factory=list)
    unknown_trip_counts: int = 0
    # the port's own: every shard's trace of a sharded program, and the
    # names of the ops no shard owns (``analyze``)
    shards: typing.Dict[int, typing.List[TraceOp]] = dataclasses.field(
        default_factory=dict)
    unattributed: typing.List[str] = dataclasses.field(default_factory=list)

    @property
    def collective_bytes(self) -> float:
        return sum(c.payload_bytes * c.count for c in self.collectives)

    def collective_bytes_by_kind(self) -> dict:
        out: dict = {}
        for c in self.collectives:
            out[c.kind] = out.get(c.kind, 0.0) + c.payload_bytes * c.count
        return out


# aten ops (by overload packet name) that move no data and do no work
FREE_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
    "permute", "transpose", "t", "slice", "select", "squeeze",
    "unsqueeze", "alias", "detach", "as_strided", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "diagonal", "unfold",
    "view_as_real", "view_as_complex", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "squeeze_",
    "unsqueeze_", "transpose_", "t_", "as_strided_",
})
MATMUL_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "dot",
                        "convolution", "convolution_backward"})


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, a stride-0 dimension counted once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """2 x (multiply-adds of a convolution): each output element of a
    direct convolution takes C_in/groups x prod(kernel) products (weight
    (C_out, C_in/groups, *k)); a transposed one spreads each input
    element over C_out/groups x prod(kernel) (weight (C_in, C_out/groups,
    *k))."""
    per = w_shape[1] * math.prod(w_shape[2:])
    return 2.0 * per * math.prod(x_shape if transposed else out_shape)


def _matmul_flops(name: str, args, out) -> float:
    if name in ("mm", "addmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name in ("bmm", "baddbmm"):
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("mv", "dot"):
        return 2.0 * args[0].numel()
    if name == "convolution":         # (x, w, bias, stride, pad, dil, transposed, ..)
        return _conv_flops(args[0].shape, args[1].shape, out.shape, args[6])
    # convolution_backward(grad_out, x, w, bias_sizes, stride, pad, dil,
    # transposed, ..., output_mask): a forward's products for each of the
    # input and weight gradients asked for
    grad_out, x, w = args[0], args[1], args[2]
    fwd = _conv_flops(x.shape, w.shape, grad_out.shape, args[7])
    return fwd * sum(bool(m) for m in args[-1][:2])


# DTensor's functional collectives (rank-local ops) -> the reference's kinds;
# wait_tensor and _wrap_tensor_autograd move nothing
FUNCTIONAL_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
_FREE_FUNCTIONAL = frozenset({"wait_tensor", "_wrap_tensor_autograd"})

def tag(t: torch.Tensor, shard: int) -> None:
    """Mark ``t`` as mesh shard ``shard``'s (``Mesh`` does it on
    ``meta``); the tracer passes the mark on to what ops make of it."""
    t._mesh_shard = shard


def _tag_of(t: torch.Tensor) -> typing.Optional[int]:
    return getattr(t, "_mesh_shard", None)


def _shard_of(tensors) -> typing.Optional[int]:
    shards = {_tag_of(t) for t in tensors} - {None}
    if len(shards) > 1:
        raise ValueError(f"an op mixes the tensors of shards {sorted(shards)}: "
                         f"the program is not one program per shard")
    return shards.pop() if shards else None


class _Tracer(TorchDispatchMode):
    def __init__(self, shards: typing.Iterable[int] = ()) -> None:
        super().__init__()
        self.cost = HloCost(shards={i: [] for i in sorted(set(shards))})
        self.sharded = bool(self.cost.shards)
        self.paused = 0

    def _append(self, op: TraceOp, shard: typing.Optional[int]) -> None:
        if not self.sharded:
            self.cost.trace.append(op)
        elif shard is None:
            self.cost.unattributed.append(op.name)
        else:
            self.cost.shards.setdefault(shard, []).append(op)

    def record(self, name: str, flops: float, hbm_bytes: float,
               shard: typing.Optional[int] = None) -> None:
        self._append(TraceOp("compute", name, flops=float(flops),
                             hbm_bytes=float(hbm_bytes)), shard)

    def record_collective(self, rec: CollectiveRecord) -> None:
        """One collective, which every device issues: in every shard's
        trace of a sharded program."""
        self.cost.collectives.append(rec)
        op = TraceOp("collective", rec.op_name, collective=rec)
        if not self.sharded:
            self.cost.trace.append(op)
        for trace in self.cost.shards.values():
            trace.append(op)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(c.__name__ == "DTensor" for t in types for c in t.__mro__):
            # let DTensor desugar the op into this rank's local ops and
            # collectives, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:             # inside a mesh collective
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        shard = _shard_of(ins) if self.sharded else None
        if shard is not None:
            for t in outs:
                tag(t, shard)
        ns, name = func.namespace, func.overloadpacket.__name__
        if ns in ("_c10d_functional", "_dtensor"):
            if name in FUNCTIONAL_COLLECTIVES:
                self._functional_collective(func, name, args, ins, outs)
            elif name not in _FREE_FUNCTIONAL:
                raise NotImplementedError(f"{func}: a collective the tracer "
                                          f"does not price")
            return out
        if name in FREE_OPS:
            return out
        flops = (_matmul_flops(name, args, out) if name in MATMUL_OPS
                 else sum(t.numel() for t in outs))
        self.record(str(func), flops,
                    sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs),
                    shard)
        return out

    def _functional_collective(self, func, name, args, ins, outs) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1])
        n = group.size()
        kind = FUNCTIONAL_COLLECTIVES[name]
        in_b = sum(_nbytes(t) for t in ins)
        out_b = sum(_nbytes(t) for t in outs)
        self.record_collective(CollectiveRecord(
            kind, str(func), out_b if kind == "all-gather" else in_b, in_b,
            out_b, [list(range(n))]))


_ACTIVE: typing.List[_Tracer] = []      # the analyze() calls in progress


def tracing() -> bool:
    """True inside ``analyze``."""
    return bool(_ACTIVE)


def _innermost(what: str) -> _Tracer:
    if not _ACTIVE:
        raise RuntimeError(f"{what}: traced only inside "
                           f"repro_torch.core.hlo.analyze")
    return _ACTIVE[-1]


def record(name: str, flops: float, hbm_bytes: float,
           inputs: typing.Sequence = ()) -> None:
    """Append one compute ``TraceOp`` to the innermost ``analyze``'s
    trace: how a hand-written kernel enters it (``kernels.ops``).  In a
    sharded program the op goes to the shard of ``inputs`` (its tensor
    operands; its meta outputs, made from them, take it as ops do)."""
    tracer = _innermost(name)
    shard = _shard_of([t for t in inputs if isinstance(t, torch.Tensor)]) \
        if tracer.sharded else None
    tracer.record(name, flops, hbm_bytes, shard)


def record_collective(kind: str, operand_bytes: int, output_bytes: int,
                      groups: typing.List[typing.List[int]],
                      name: str = "") -> CollectiveRecord:
    """Append one collective to the innermost ``analyze``: a
    ``CollectiveRecord`` (payload the operand bytes, the output bytes for
    ``all-gather``, as the reference's parser) and its ``TraceOp``."""
    tracer = _innermost(kind)
    rec = CollectiveRecord(
        kind, name or f"{kind}.{len(tracer.cost.collectives)}",
        int(output_bytes if kind == "all-gather" else operand_bytes),
        int(operand_bytes), int(output_bytes), [list(g) for g in groups])
    tracer.record_collective(rec)
    return rec


@contextlib.contextmanager
def paused():
    """Inside ``analyze``: the ops run here are not recorded (a mesh
    collective's own copies, which its ``CollectiveRecord`` stands
    for).  Outside ``analyze``: nothing."""
    tracer = _ACTIVE[-1] if _ACTIVE else None
    if tracer is not None:
        tracer.paused += 1
    try:
        yield
    finally:
        if tracer is not None:
            tracer.paused -= 1


def analyze(fn, *args, **kwargs) -> HloCost:
    """The cost trace of ``fn(*args, **kwargs)``: one ``TraceOp`` per aten
    op that does work, per hand-written kernel call and per collective,
    in program order (backward ops included, where ``fn``
    differentiates).  Pass ``meta`` tensors to trace a program without
    running it.  If an argument carries a shard tag (a D-mode program's
    shards, placed by ``Mesh`` on ``meta``), the trace is shard 0's and
    ``HloCost.shards`` holds every shard's."""
    # a DTensor's shard is its local tensor's
    leaves = [getattr(t, "_local_tensor", t) for t in tree_leaves(
        (args, kwargs)) if isinstance(t, torch.Tensor)]
    tracer = _Tracer(_tag_of(t) for t in leaves if _tag_of(t) is not None)
    _ACTIVE.append(tracer)
    try:
        with tracer:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    cost = tracer.cost
    if tracer.sharded:
        cost.trace = list(cost.shards.get(0, []))
    compute = [op for op in cost.trace if op.kind == "compute"]
    cost.flops = sum(op.flops for op in compute)
    cost.hbm_bytes = sum(op.hbm_bytes for op in compute)
    return cost


def asymmetric_shards(cost: HloCost) -> typing.List[int]:
    """The shards whose trace (op names, FLOPs, bytes, collectives)
    differs from shard 0's: empty for an SPMD program."""
    base = cost.shards.get(0, [])
    return sorted(i for i, ops in cost.shards.items() if ops != base)


def cost_analysis(cost: HloCost) -> dict:
    """``build_terms``'s ``cost_analysis`` argument from the trace itself:
    ``{"flops", "bytes accessed"}`` of ``cost`` (the port has no
    compiler's own count to take it from)."""
    return {"flops": cost.flops, "bytes accessed": cost.hbm_bytes}


def matmul_flops(cost: HloCost) -> float:
    """FLOPs of the trace's matrix-product ops (not the kernels')."""
    return sum(op.flops for op in cost.trace
               if op.name.startswith("aten.")
               and op.name.split(".")[1] in MATMUL_OPS)


def kernel_ops(trace: typing.Iterable[TraceOp]) -> typing.Dict[str, int]:
    """{kernel name: how many} of the hand-written kernel calls in a
    trace (its compute ops that are no aten op)."""
    out: typing.Dict[str, int] = {}
    for op in trace:
        if op.kind == "compute" and not op.name.startswith("aten."):
            out[op.name] = out.get(op.name, 0) + 1
    return out


def count_ops(cost: HloCost) -> typing.Dict[str, int]:
    """{TraceOp name: how many} of a trace."""
    out: typing.Dict[str, int] = {}
    for op in cost.trace:
        out[op.name] = out.get(op.name, 0) + 1
    return out
