"""Turn a parsed HLO cost model into a replayable device trace.

The bridge between DP-1 (machine-level program) and the system model:
``HloCost.trace`` is a per-device op list in program order; here we

* expand ``while``-loop repeats (each iteration's collectives must
  synchronize separately -- that ordering is what makes stragglers and
  link contention visible),
* compress runs of consecutive compute ops into single roofline segments
  (they serialize on one TensorCore anyway, so timing is preserved while
  event count drops by ~20x),
* resolve collective payloads + replica groups into :class:`_RunOp`.

``repeat_cap`` bounds trace length for very deep loops: beyond the cap we
fold the remaining iterations' compute into proportionally larger
segments (time-equivalent because iterations are identical), keeping
event counts tractable on the single-core host that runs the simulator.
"""
from __future__ import annotations

import typing

from .hlo import HloCost, TraceOp
from .system import _RunOp

__all__ = ["build_runops", "_RunOp"]


def _segment(ops: typing.List[TraceOp], scale: float = 1.0) -> _RunOp:
    return _RunOp(kind="compute", name=ops[0].name if ops else "seg",
                  flops=scale * sum(o.flops * o.repeat for o in ops),
                  hbm_bytes=scale * sum(o.hbm_bytes * o.repeat for o in ops),
                  tag="compute")


def build_runops(cost: HloCost, dtype_bits: int = 16,
                 repeat_cap: int = 64) -> typing.List[_RunOp]:
    """Flatten HloCost.trace into runnable ops.

    ``HloCost.trace`` already carries per-op ``repeat`` (loop trip counts).
    Consecutive compute ops merge into one segment.  A collective with
    repeat R is emitted min(R, cap) times, with compute segments around it
    scaled so total work matches exactly.
    """
    runops: typing.List[_RunOp] = []
    pending_compute: typing.List[TraceOp] = []

    def flush(scale: float = 1.0) -> None:
        if pending_compute:
            seg = _segment(pending_compute, scale)
            seg.dtype_bits = dtype_bits
            if seg.flops or seg.hbm_bytes:
                runops.append(seg)
            pending_compute.clear()

    for op in cost.trace:
        if op.kind == "compute":
            pending_compute.append(op)
            continue
        rec = op.collective
        reps = max(1, int(round(rec.count)))
        emit = min(reps, repeat_cap)
        scale = reps / emit
        # the compute accumulated so far belongs "before" this collective;
        # within a loop it interleaves -- approximate by splitting evenly
        # across emitted instances (time-equivalent for identical bodies).
        if pending_compute and emit > 1:
            segs = [_segment(pending_compute, 1.0 / emit) for _ in range(emit)]
            pending_compute.clear()
        else:
            flush()
            segs = [None] * emit
        per_shard = rec.payload_bytes
        for i in range(emit):
            if segs[i] is not None:
                segs[i].dtype_bits = dtype_bits
                runops.append(segs[i])
            runops.append(_RunOp(
                kind="collective", name=f"{rec.op_name}",
                coll_kind=rec.kind, bytes=per_shard * scale,
                group=tuple(tuple(g) for g in rec.groups)))
    flush()
    return runops
