"""Timeline simulation driver: replay a compiled program on the system model.

This is the MGSim use-case end to end: take the *machine-level program*
(post-SPMD HLO of the real JAX computation), turn it into per-device op
traces, and replay them on the component/connection system model.  The
output is what the paper's case study needs: end-to-end time, per-link
traffic, utilization, and what-if answers for stragglers/failures.

Device-count control: simulating all 256/512 chips is exact but O(chips)
events on a single host core.  ``device_limit`` simulates a representative
closed subgroup (complete replica groups only) and is validated to give
identical per-device timing for SPMD traces (every device runs the same
program; contention *within* a ring is modeled analytically inside
``Topology.collective_time_s``, so a subgroup that contains whole groups
reproduces full-system timing exactly — asserted in
``tests/test_sim_system.py::test_subgroup_timing_invariant``).
"""
from __future__ import annotations

import dataclasses
import typing

from .hlo import HloCost
from .hooks import FaultInjector, MetricsHook
from .hw import SystemSpec, s_to_ps
from .system import System
from .trace import build_runops


@dataclasses.dataclass
class SimReport:
    time_s: float
    events: int
    devices: int
    devices_done: int
    devices_aborted: int
    collectives_completed: int
    collective_timeouts: int
    compute_busy_s: float          # max over simulated cores
    compute_util: float            # busy / end-to-end (bottleneck core)
    link_report: dict
    fabric: str = "analytic"       # which interconnect backend priced it
    link_utilization: dict = dataclasses.field(default_factory=dict)
    scheduler: str = "serial"      # which engine scheduler produced this
    executor: str = "none"         # where grouped rounds ran (threads /
                                   # procs; "none" for the serial scheduler)
    batch_widths: typing.List[int] = dataclasses.field(default_factory=list)
    window_widths: typing.List[int] = dataclasses.field(default_factory=list)

    # Execution artifacts (how the engine drained the queue) are excluded:
    # summaries must be bit-identical across schedulers AND executors,
    # and the parametrized determinism tests compare exactly this dict.
    _EXECUTION_FIELDS = ("scheduler", "executor", "batch_widths",
                         "window_widths")

    def summary(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if k not in self._EXECUTION_FIELDS}


def _select_devices(cost: HloCost, total: int,
                    device_limit: typing.Optional[int]) -> typing.List[int]:
    """Pick a closed set of devices covering complete replica groups."""
    if device_limit is None or device_limit >= total:
        return list(range(total))
    chosen: set = set()
    for rec in cost.collectives:
        for g in rec.groups:
            if chosen.union(g) and len(chosen | set(g)) <= device_limit:
                chosen |= set(g)
            if len(chosen) >= device_limit:
                break
    if not chosen:
        chosen = set(range(min(device_limit, total)))
    # close over groups: any group touching a chosen device joins fully
    changed = True
    while changed:
        changed = False
        for rec in cost.collectives:
            for g in rec.groups:
                s = set(g)
                if s & chosen and not s <= chosen:
                    chosen |= s
                    changed = True
    return sorted(chosen)


def simulate(hlo_text: str = None, cost: HloCost = None,
             spec: SystemSpec = None, parallel: bool = False,
             scheduler: str = None, max_workers: int = 4,
             fabric: str = None, executor: str = None,
             device_limit: typing.Optional[int] = 32,
             dtype_bits: int = 16, repeat_cap: int = 64,
             faults: dict = None, deadline_s: float = None,
             until_s: float = None) -> SimReport:
    """Simulate one compiled step on the modeled machine.

    ``scheduler``: engine scheduler name ("serial" | "batch" |
    "lookahead"); defaults to "serial".  The legacy ``parallel=True``
    knob maps to "batch" with a ``DeprecationWarning``.  All schedulers
    produce bit-identical ``SimReport.summary()``s.

    ``executor``: where round schedulers run grouped work ("threads" |
    "procs"); defaults to "threads".  "procs" executes handlers in
    shard-resident worker processes (real cores, no GIL) and is
    bit-identical too -- engine-level hook state is merged back at the
    end of the run (hooks that define ``merge_shard``).  Ignored by the
    serial scheduler.

    ``fabric``: interconnect backend name ("analytic" | "event");
    defaults to ``spec.fabric``.  See docs/fabric.md.

    ``faults``: {component_name: [(time_s, action, arg), ...]} — forwarded
    to :class:`FaultInjector` (times converted to ps; a ``"transient"``
    action's duration arg is in seconds and converted too).  With the
    event fabric the plan may also target links / DMA engines by name,
    e.g. ``{"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 8.0)]}`` for a
    degraded (straggler) link.  Full plan grammar: docs/faults.md.
    """
    assert (hlo_text is None) != (cost is None), "pass hlo_text xor cost"
    if cost is None:
        # the port traces torch programs (``hlo.analyze(fn, *args)``);
        # it has no parser of XLA's HLO text
        raise ValueError("the port simulates an HloCost: pass "
                         "cost=repro_torch.core.analyze(fn, *args), not "
                         "hlo_text")
    spec = spec or SystemSpec()
    system = System(spec, parallel=parallel, deadline_s=deadline_s,
                    scheduler=scheduler, max_workers=max_workers,
                    fabric=fabric, executor=executor)
    metrics = MetricsHook()
    # Engine-level hook only: it already sees busy intervals + requests,
    # and hooks attached directly to connections would mark them
    # stateful_send, fusing clusters and shrinking engine parallelism.
    system.engine.accept_hook(metrics)
    if faults:
        plan = {name: [(s_to_ps(t), a,
                        s_to_ps(arg) if a == "transient" else arg)
                       for (t, a, arg) in acts]
                for name, acts in faults.items()}
        targets = (system.cores + system.programs
                   + system.fabric.fault_targets())
        unknown = set(plan) - {c.name for c in targets}
        if unknown:
            raise ValueError(
                f"fault plan targets unknown components "
                f"{sorted(unknown)}; chips are chipN.core / chipN.prog, "
                f"and fabric.* link/DMA targets require fabric='event' "
                f"(this run uses {system.fabric.name!r})")
        inj = FaultInjector(plan)
        for comp in targets:
            comp.accept_hook(inj)
        inj.arm(targets)   # actions apply on schedule even on idle targets

    runops = build_runops(cost, dtype_bits=dtype_bits, repeat_cap=repeat_cap)
    devices = _select_devices(cost, spec.total_chips, device_limit)
    system.load_trace(runops, devices)
    result = system.run(until_s=until_s)

    busy = max((metrics.busy_ps[c.name] for c in system.cores), default=0)
    t = result["time_s"]
    return SimReport(
        time_s=t,
        events=result["events"],
        devices=len(devices),
        devices_done=result["devices_done"],
        devices_aborted=result["devices_aborted"],
        collectives_completed=result["collectives_completed"],
        collective_timeouts=result["collective_timeouts"],
        compute_busy_s=busy / 1e12,
        compute_util=(busy / 1e12) / t if t else 0.0,
        link_report=system.fabric.link_report(),
        fabric=system.fabric.name,
        link_utilization=system.fabric.link_utilization(
            s_to_ps(t) if t else None),
        scheduler=system.engine.scheduler.name,
        executor=(system.engine.scheduler.executor.name
                  if getattr(system.engine.scheduler, "executor", None)
                  is not None else "none"),
        batch_widths=system.engine.batch_widths,
        window_widths=system.engine.window_widths,
    )


def what_if_straggler(cost: HloCost, spec: SystemSpec, device: int = 0,
                      slow_factor: float = 2.0, device_limit: int = 32,
                      scheduler: str = None, executor: str = None,
                      fabric: str = None,
                      max_workers: int = 4) -> typing.Tuple[SimReport, SimReport]:
    """Paper-style what-if: one chip at `slow_factor`x — whole-system cost.
    Scheduler/executor/fabric pass straight through to :func:`simulate`
    (the what-if answer is bit-identical under all of them)."""
    base = simulate(cost=cost, spec=spec, device_limit=device_limit,
                    scheduler=scheduler, executor=executor, fabric=fabric,
                    max_workers=max_workers)
    slow = simulate(cost=cost, spec=spec, device_limit=device_limit,
                    scheduler=scheduler, executor=executor, fabric=fabric,
                    max_workers=max_workers,
                    faults={f"chip{device}.core": [(0.0, "slow", slow_factor)]})
    return base, slow


def what_if_failure(cost: HloCost, spec: SystemSpec, device: int = 0,
                    fail_at_s: float = 0.0, deadline_s: float = 0.5,
                    device_limit: int = 32, scheduler: str = None,
                    executor: str = None, fabric: str = None,
                    max_workers: int = 4) -> SimReport:
    """Kill one chip; collectives time out via the coordinator deadline —
    the failure-detection signal the fault-tolerant trainer reacts to."""
    return simulate(cost=cost, spec=spec, device_limit=device_limit,
                    deadline_s=deadline_s, scheduler=scheduler,
                    executor=executor, fabric=fabric, max_workers=max_workers,
                    faults={f"chip{device}.prog": [(fail_at_s, "fail", None)]})
