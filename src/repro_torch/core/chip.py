"""TPU chip components: TensorCore + HBM controller.

These mirror the paper's CU / cache / memory-controller components, at
the granularity XLA actually schedules: fused ops.  A fused op occupies
the TensorCore for ``max(flops/peak, hbm_bytes/bw) + launch_overhead``
(the roofline duration), reports the HBM traffic to the HBM controller
via a request (so HBM occupancy is observable), and answers the
requesting DeviceProgram when done.

Stragglers: the FaultInjector hook sets ``fault_slow_factor`` (read here,
mutated nowhere else) -- compute durations stretch, and collectives that
include this chip stretch with it.  (Interconnect-side stragglers --
degraded links -- live in the fabric components instead:
``repro.fabric.event.FabricLink`` reads the same flag.)
"""
from __future__ import annotations

import dataclasses

from .component import Component
from .connection import Request
from .event import Event
from .hw import ChipSpec, s_to_ps


@dataclasses.dataclass
class ComputeJob:
    flops: float
    hbm_bytes: float
    dtype_bits: int = 16
    tag: str = "compute"
    reply_to: object = None     # DeviceProgram
    token: object = None


class TensorCore(Component):
    def __init__(self, name: str, spec: ChipSpec) -> None:
        super().__init__(name)
        self.spec = spec
        self.busy_until_ps = 0
        self.total_flops = 0.0

    def duration_ps(self, job: ComputeJob) -> int:
        t_compute = job.flops / self.spec.flops_for_dtype(job.dtype_bits)
        t_mem = job.hbm_bytes / self.spec.hbm_bandwidth
        # the slow factor stretches the whole roofline term, not just the
        # flops leg: a throttled chip is slow on memory-bound ops too
        # (dividing only the flops peak made stragglers invisible on any
        # hbm-bound trace)
        return s_to_ps(max(t_compute, t_mem) * self.fault_slow_factor
                       + self.spec.op_launch_overhead_s)

    def handle(self, event: Event) -> None:
        if event.kind == "request":
            job: ComputeJob = event.payload.payload
            now = event.time               # == engine.now inside a handler
            start = max(now, self.busy_until_ps)
            end = start + self.duration_ps(job)
            self.busy_until_ps = end
            self.total_flops += job.flops
            self.mark_busy(start, end, job.tag)
            # tell HBM about the traffic (observable occupancy, DP-4)
            if "hbm" in self.ports and job.hbm_bytes:
                self.port("hbm").send(Request(
                    src=self.port("hbm"), dst=None, kind="traffic",
                    size_bytes=int(job.hbm_bytes)))
            self.schedule("job_done", end - now, payload=job)
        elif event.kind == "job_done":
            job: ComputeJob = event.payload
            self.port("prog").send(Request(
                src=self.port("prog"), dst=job.reply_to, kind="compute_done",
                payload=job.token))


class HbmController(Component):
    """Tracks HBM occupancy from TensorCore traffic requests."""

    def __init__(self, name: str, spec: ChipSpec) -> None:
        super().__init__(name)
        self.spec = spec
        self.bytes_total = 0
        self.busy_until_ps = 0

    def handle(self, event: Event) -> None:
        if event.kind == "request":
            req: Request = event.payload
            self.bytes_total += req.size_bytes
            start = max(event.time, self.busy_until_ps)
            end = start + s_to_ps(req.size_bytes / self.spec.hbm_bandwidth)
            self.busy_until_ps = end
            self.mark_busy(start, end, "hbm")
