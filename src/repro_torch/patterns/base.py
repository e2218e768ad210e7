"""MGMark common harness (port of ``repro/patterns/base.py``).

Every workload module exposes:
    reference(...)            -- numpy (or plain PyTorch) oracle
    make_umode(mesh)          -- the global program on one device, with
                                 the reference's sharding constraints
                                 (``unified.unified``)
    make_dmode(mesh)          -- over the mesh's shards, every collective
                                 explicit (``mesh.shard_map``)
    PATTERN                   -- its collaborative-execution pattern
    default_size(n_devices)   -- Table-2 sizing (4-device column scaled)
    make_args(size, seed)     -- numpy inputs, bit-equal to the reference's

``evaluate`` runs one mode, checks the output against the oracle as the
reference does, reads the mesh's collective counter and the kernels the
run launched, then prices the mode as the reference does
(``repro/patterns/base.py:51-74``): the program is traced on ``meta``
inputs of the same shapes and dtypes (nothing runs; the kernels record
their work from ``kernels/cost.py``) into one device's trace, replayed by
``simulate`` on a ``SystemSpec`` of ``mesh.size`` chips.  D-mode's trace
is shard 0's program (every shard's must be the same); U-mode's is rank
0's program under DTensor (``unified.trace``), whose collectives are its
traffic.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
import typing

import numpy as np
import torch

from repro_torch.core import SystemSpec, hlo, simulate
from repro_torch.kernels import ops

from . import unified
from .mesh import Mesh, Program

MODES = ("umode", "dmode")


@dataclasses.dataclass
class PatternReport:
    name: str
    mode: str                       # "umode" | "dmode"
    pattern: str
    correct: bool
    max_err: float
    collective_bytes: typing.Optional[float]   # per device
    bytes_by_kind: typing.Optional[dict]
    sim_time_s: typing.Optional[float] = None  # simulated, on ``spec``
    compute_util: typing.Optional[float] = None
    flops: typing.Optional[float] = None
    hbm_bytes: typing.Optional[float] = None
    device: str = ""
    launches: dict = dataclasses.field(default_factory=dict)
    device_ms: typing.Optional[float] = None   # CUDA events; None off-card
    cost: typing.Optional[hlo.HloCost] = dataclasses.field(
        default=None, repr=False)              # the priced trace

    def row(self) -> str:
        coll = ("n/a" if self.collective_bytes is None
                else f"{self.collective_bytes:.0f}B")
        ms = ("not measured" if self.device_ms is None
              else f"{self.device_ms:.4f} ms")
        sim = ("" if self.sim_time_s is None else
               f" sim={self.sim_time_s * 1e3:.6f}ms(simulated) "
               f"util={self.compute_util:.3f}")
        kernels = {k: v for k, v in self.launches.items() if v}
        return (f"{self.name:4s} {self.mode:6s} {self.pattern:12s} "
                f"ok={self.correct} err={self.max_err:.3g} "
                f"coll={coll}{sim} {ms} on {self.device} "
                f"launches={kernels}")


def max_abs_err(out: np.ndarray, oracle: np.ndarray) -> float:
    """The reference's error: float outputs in f64, integer ones in
    int64."""
    if out.shape != oracle.shape:
        raise ValueError(f"output {out.shape} against oracle {oracle.shape}")
    if np.issubdtype(out.dtype, np.floating):
        return float(np.max(np.abs(out.astype(np.float64)
                                   - oracle.astype(np.float64))))
    return float(np.max(np.abs(out.astype(np.int64)
                               - oracle.astype(np.int64))))


def trace(fn: Program, args) -> hlo.HloCost:
    """One device's cost trace of ``fn`` on ``meta`` inputs shaped as
    ``args`` (numpy or tensors): shard 0's program for a D-mode ``fn``
    (raises unless every shard's trace is the same), rank 0's under
    DTensor for a U-mode one."""
    meta = [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in map(torch.as_tensor, args)]
    if fn.in_specs is None:
        return unified.trace(fn, meta)
    cost = hlo.analyze(fn, *fn.place(*meta))
    odd = hlo.asymmetric_shards(cost)
    if odd:
        raise ValueError(f"shards {odd} run another program than shard 0: "
                         f"the simulator replays shard 0's on every device")
    return cost


def evaluate(name: str, pattern: str, mode: str, fn: Program, args,
             oracle, mesh: Mesh, atol: float = 2e-2,
             repeats: int = 0, spec: SystemSpec = None,
             device_limit: int = 8) -> PatternReport:
    """Run ``fn`` (a pattern's program in ``mode``) once on ``args``
    (numpy or tensors), check it against ``oracle`` and read the mesh's
    collective bytes and the kernels launched by that run.  With
    ``repeats`` on a CUDA mesh, then time it: CUDA events around one
    call of the program on placed inputs (after one warm call), median
    of ``repeats``; those calls are not in ``launches``.  Then price it:
    ``trace`` replayed by ``simulate`` on ``spec`` (default
    ``SystemSpec(pod_shape=(1, mesh.size))``, the reference's).  D-mode
    bytes are the counter's (equal to the trace's); U-mode bytes are the
    collectives of its DTensor trace."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    placed = fn.place(*args)
    dev = mesh.devices[0]
    mesh.reset_bytes()
    before = ops.launch_counts()
    out = fn.gather(fn(*placed))
    after = ops.launch_counts()
    counted = (mesh.collective_bytes, dict(mesh.bytes_by_kind))
    out = out.cpu().numpy()
    err = max_abs_err(out, np.asarray(oracle))
    device_ms = time_ms(fn, placed, repeats) \
        if repeats and dev.type == "cuda" else None
    dmode = mode == "dmode"
    mesh.reset_bytes()
    cost = trace(fn, args)
    if dmode and cost.collective_bytes_by_kind() != counted[1]:
        raise RuntimeError(f"{name}: traced collectives "
                           f"{cost.collective_bytes_by_kind()} against the "
                           f"counted {counted[1]}")
    spec = spec or SystemSpec(pod_shape=(1, mesh.size))
    sim = simulate(cost=cost, spec=spec, device_limit=device_limit)
    ca = hlo.cost_analysis(cost)
    return PatternReport(
        name=name, mode=mode, pattern=pattern, correct=bool(err <= atol),
        max_err=err,
        collective_bytes=counted[0] if dmode else cost.collective_bytes,
        bytes_by_kind=counted[1] if dmode else cost.collective_bytes_by_kind(),
        sim_time_s=sim.time_s, compute_util=sim.compute_util,
        flops=float(ca["flops"]), hbm_bytes=float(ca["bytes accessed"]),
        device=str(dev), launches={k: after[k] - before[k] for k in after},
        device_ms=device_ms, cost=cost)


def finite(rep: PatternReport) -> bool:
    """The simulated fields are filled and finite."""
    return all(v is not None and math.isfinite(v) for v in (
        rep.sim_time_s, rep.compute_util, rep.flops, rep.hbm_bytes))


def time_ms(fn: Program, placed, repeats: int) -> float:
    """Median device ms of one call of ``fn`` on ``placed``, between two
    CUDA events (host gaps between its launches included)."""
    fn(*placed)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*placed)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
