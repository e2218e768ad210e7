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
* Collectives (``patterns/mesh.py``'s counted copies) are not traced
  yet: a traced program that reaches one raises ``NotImplementedError``.

On ``meta`` a program allocates nothing, so a full-size model traces on
a host without its weights.  ``cost_analysis(cost)`` hands
``roofline.build_terms`` the tracer's own counts in place of XLA's
``compiled.cost_analysis()`` (the reference's
``compat.cost_analysis_dict``, which reads a compiled XLA object).
"""
from __future__ import annotations

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


class _Tracer(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.cost = HloCost()

    def record(self, name: str, flops: float, hbm_bytes: float) -> None:
        self.cost.flops += flops
        self.cost.hbm_bytes += hbm_bytes
        self.cost.trace.append(TraceOp("compute", name, flops=float(flops),
                                       hbm_bytes=float(hbm_bytes)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in FREE_OPS:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        flops = (_matmul_flops(name, args, out) if name in MATMUL_OPS
                 else sum(t.numel() for t in outs))
        self.record(str(func), flops,
                    sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))
        return out


_ACTIVE: typing.List[_Tracer] = []      # the analyze() calls in progress


def tracing() -> bool:
    """True inside ``analyze``."""
    return bool(_ACTIVE)


def record(name: str, flops: float, hbm_bytes: float) -> None:
    """Append one compute ``TraceOp`` to the innermost ``analyze``'s
    trace: how a hand-written kernel enters it (``kernels.ops``)."""
    if not _ACTIVE:
        raise RuntimeError(f"{name}: a kernel is traced only inside "
                           f"repro_torch.core.hlo.analyze")
    _ACTIVE[-1].record(name, flops, hbm_bytes)


def analyze(fn, *args, **kwargs) -> HloCost:
    """The cost trace of ``fn(*args, **kwargs)``: one ``TraceOp`` per aten
    op that does work and per hand-written kernel call, in program order
    (backward ops included, where ``fn`` differentiates).  Pass ``meta``
    tensors to trace a program without running it."""
    tracer = _Tracer()
    _ACTIVE.append(tracer)
    try:
        with tracer:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    return tracer.cost


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


def count_ops(cost: HloCost) -> typing.Dict[str, int]:
    """{TraceOp name: how many} of a trace."""
    out: typing.Dict[str, int] = {}
    for op in cost.trace:
        out[op.name] = out.get(op.name, 0) + 1
    return out
