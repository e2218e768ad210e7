"""MGMark common harness (port of ``repro/patterns/base.py``).

Every workload module exposes:
    reference(...)            -- numpy (or plain PyTorch) oracle
    make_umode(mesh)          -- the global program on one device
    make_dmode(mesh)          -- over the mesh's shards, every collective
                                 explicit (``mesh.shard_map``)
    PATTERN                   -- its collaborative-execution pattern
    default_size(n_devices)   -- Table-2 sizing (4-device column scaled)
    make_args(size, seed)     -- numpy inputs, bit-equal to the reference's

``evaluate`` runs one mode, checks the output against the oracle as the
reference does and reads the mesh's collective counter.  The reference
also prices the compiled HLO on its system model (``sim_time_s``,
``compute_util``, ``flops``, ``hbm_bytes``); the port has no cost front
end yet, so those fields stay None.  U-mode's traffic is None too: the
reference's U-mode bytes are GSPMD's choices, and the port's U-mode is
the global program on one device, which moves nothing between shards.
"""
from __future__ import annotations

import dataclasses
import statistics
import typing

import numpy as np
import torch

from repro_torch.kernels import ops

from .mesh import Mesh, Program

MODES = ("umode", "dmode")


@dataclasses.dataclass
class PatternReport:
    name: str
    mode: str                       # "umode" | "dmode"
    pattern: str
    correct: bool
    max_err: float
    collective_bytes: typing.Optional[float]   # per device; None in U-mode
    bytes_by_kind: typing.Optional[dict]
    sim_time_s: typing.Optional[float] = None  # need the cost front end
    compute_util: typing.Optional[float] = None
    flops: typing.Optional[float] = None
    hbm_bytes: typing.Optional[float] = None
    device: str = ""
    launches: dict = dataclasses.field(default_factory=dict)
    device_ms: typing.Optional[float] = None   # CUDA events; None off-card

    def row(self) -> str:
        coll = ("n/a" if self.collective_bytes is None
                else f"{self.collective_bytes:.0f}B")
        ms = ("not measured" if self.device_ms is None
              else f"{self.device_ms:.4f} ms")
        kernels = {k: v for k, v in self.launches.items() if v}
        return (f"{self.name:4s} {self.mode:6s} {self.pattern:12s} "
                f"ok={self.correct} err={self.max_err:.3g} "
                f"coll={coll} {ms} on {self.device} launches={kernels}")


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


def evaluate(name: str, pattern: str, mode: str, fn: Program, args,
             oracle, mesh: Mesh, atol: float = 2e-2,
             repeats: int = 0) -> PatternReport:
    """Run ``fn`` (a pattern's program in ``mode``) once on ``args``
    (numpy or tensors), check it against ``oracle`` and read the mesh's
    collective bytes and the kernels launched by that run.  With
    ``repeats`` on a CUDA mesh, then time it: CUDA events around one
    call of the program on placed inputs (after one warm call), median
    of ``repeats``; those calls are not in ``launches``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    placed = fn.place(*args)
    dev = mesh.devices[0]
    mesh.reset_bytes()
    before = ops.launch_counts()
    out = fn.gather(fn(*placed))
    after = ops.launch_counts()
    out = out.cpu().numpy()
    err = max_abs_err(out, np.asarray(oracle))
    dmode = mode == "dmode"
    rep = PatternReport(
        name=name, mode=mode, pattern=pattern, correct=bool(err <= atol),
        max_err=err,
        collective_bytes=mesh.collective_bytes if dmode else None,
        bytes_by_kind=dict(mesh.bytes_by_kind) if dmode else None,
        device=str(dev), launches={k: after[k] - before[k] for k in after})
    if repeats and dev.type == "cuda":
        rep.device_ms = time_ms(fn, placed, repeats)
    return rep


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
