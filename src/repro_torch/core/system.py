"""System model builder: an N-pod TPU machine as engine-registered components.

This is the multi-GPU-platform configuration step of the paper (Sec. 4.3)
transplanted to pods: from a :class:`SystemSpec` we instantiate, per chip,
a :class:`TensorCore` + :class:`HbmController` + :class:`DeviceProgram`,
wire them with connections, and add one :class:`CollectiveCoordinator`
reachable from every device.  The interconnect itself is a pluggable
``repro.fabric`` backend installed next to the coordinator (``fabric=``,
default ``SystemSpec.fabric``).  Swapping any piece (a different HBM
model, a 3-D torus, a third fabric) is new wiring here -- zero edits to
components (DP-2).
"""
from __future__ import annotations

import dataclasses
import typing
import warnings

from .chip import HbmController, TensorCore
from .component import Component
from .connection import Connection, Request
from .engine import Engine
from .event import Event
from .hw import SystemSpec, s_to_ps


@dataclasses.dataclass
class DeviceDone:
    device: int
    time_ps: int
    aborted: bool = False


class DeviceProgram(Component):
    """Replays one device's op trace (SPMD: all devices share the trace).

    States: issue next op -> wait for compute_done / collective_done ->
    advance.  The program never touches another component's state: compute
    goes to its TensorCore via a connection, collectives join through the
    coordinator connection (DP-3).
    """

    def __init__(self, name: str, device: int) -> None:
        super().__init__(name)
        self.device = device
        self.trace: list = []           # list of _RunOp (set by System.load)
        self.pc = 0
        self.done = False
        self.aborted = False
        self.finish_ps = 0
        self._coll_occurrence: dict = {}

    def start(self) -> None:
        self.schedule("advance")

    def handle(self, event: Event) -> None:
        if event.kind == "advance":
            self._issue()
        elif event.kind == "request":
            req = event.payload
            if req.kind in ("compute_done", "collective_done"):
                self.pc += 1
                self._issue()
            elif req.kind == "collective_timeout":
                self.aborted = True
                self.done = True
                self.finish_ps = self.engine.now

    def _issue(self) -> None:
        from .chip import ComputeJob  # local import to avoid cycle at module load
        if self.done:
            return
        if self.pc >= len(self.trace):
            self.done = True
            self.finish_ps = self.engine.now
            return
        op = self.trace[self.pc]
        if op.kind == "compute":
            self.port("core").send(Request(
                src=self.port("core"), dst=None, kind="job",
                payload=ComputeJob(flops=op.flops, hbm_bytes=op.hbm_bytes,
                                   dtype_bits=op.dtype_bits, tag=op.tag,
                                   reply_to=self)))
        else:  # collective
            occ = self._coll_occurrence.get(op.name, 0)
            self._coll_occurrence[op.name] = occ + 1
            self.port("coll").send(Request(
                src=self.port("coll"), dst=None, kind="join",
                size_bytes=int(op.bytes),
                payload=(op.name, occ, op.coll_kind, op.bytes, op.group,
                         self.device, self)))


class CollectiveCoordinator(Component):
    """Synchronizes collective ops: waits for every member of a replica
    group, hands the transfer to the fabric backend (over its ``fabric``
    port), and notifies all members when the fabric reports completion.
    A straggler delays its whole group -- the paper's
    cross-device-traffic bottleneck made visible.

    The coordinator is fabric-agnostic: the ``analytic`` backend answers
    after one closed-form delay, the ``event`` backend after its per-hop
    transfer events drain (see ``repro.fabric``).

    ``deadline_s``: if a group's collective has not *completed* within the
    deadline of the first join -- a member never joined (chip death) or
    the fabric transfer stalled (link fault) -- members that did join
    receive ``collective_timeout`` (failure-detection substrate for the
    fault-tolerance studies).  ``collective_done``/``collective_timeout``
    carry the collective key as payload so callers that interleave
    iterations (the serving programs) can discard stale notifications; a
    wired ``health`` port additionally receives a ``timeout_report`` with
    the joined-member roster, which is what a failure detector needs to
    tell "who is missing" from "the transfer died".
    """

    def __init__(self, name: str, deadline_s: float = None) -> None:
        super().__init__(name)
        self.deadline_ps = s_to_ps(deadline_s) if deadline_s else None
        self.pending: dict = {}       # key -> list[(device, program)]
        self.completed = 0
        self.timed_out: list = []

    def handle(self, event: Event) -> None:
        if event.kind == "request":
            req = event.payload
            if req.kind == "join":
                self._join(req)
            elif req.kind == "fabric_done":
                self._complete(req.payload)
        elif event.kind == "deadline":
            key = event.payload
            members = self.pending.pop(key, None)
            if members is None:
                return                # completed within the deadline
            self.timed_out.append(key)
            for _, prog in members:
                self.port("coll").send(Request(
                    src=self.port("coll"), dst=prog,
                    kind="collective_timeout", payload=key))
            health = self.ports.get("health")
            if health is not None and health.connection is not None:
                health.send(Request(
                    src=health, dst=None, kind="timeout_report",
                    payload=(key, tuple(d for d, _ in members))))

    def _join(self, req: Request) -> None:
        name, occ, kind, nbytes, group, device, prog = req.payload
        key = (name, occ, tuple(group))
        members = self.pending.setdefault(key, [])
        if not members and self.deadline_ps:
            self.schedule("deadline", self.deadline_ps, payload=key)
        members.append((device, prog))
        if len(members) == len(group):
            self.port("fabric").send(Request(
                src=self.port("fabric"), dst=None, kind="start",
                size_bytes=int(nbytes),
                payload=(key, kind, nbytes, list(group))))

    def _complete(self, key) -> None:
        members = self.pending.pop(key, None)
        if members is None:
            return                    # timed out before the fabric finished
        self.completed += 1
        for _, prog in members:
            self.port("coll").send(Request(
                src=self.port("coll"), dst=prog, kind="collective_done",
                payload=key))


class StarConnection(Connection):
    """Hub-and-spoke fabric: requests from spokes route to the hub owner
    (the collective coordinator); hub requests carry an explicit dst.
    Routing lives in the connection — components still hold no peer
    references (DP-3)."""

    def __init__(self, name: str, hub_port, latency_s: float = 0.0) -> None:
        super().__init__(name, latency_s)
        self.hub = hub_port
        self.plug(hub_port)

    def _resolve_dst(self, src_port, request) -> None:
        if request.dst is None and src_port is not self.hub:
            request.dst = self.hub.owner

    def cluster_edges(self):
        """Star, not clique: spoke traffic only ever reaches the hub's
        cluster, and hub traffic only ever reaches a spoke's -- two
        spokes never exchange events directly, so bounded-lag horizons
        couple each device cluster to the coordinator alone (two
        control-latency hops apart from each other, not one)."""
        lat = self.min_latency_ps
        hub = self.hub.owner.cluster_id
        for port in self.endpoints:
            spoke = port.owner.cluster_id
            if spoke != hub:
                yield (spoke, hub, lat)
                yield (hub, spoke, lat)


@dataclasses.dataclass
class _RunOp:
    kind: str                   # 'compute' | 'collective'
    name: str = ""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    dtype_bits: int = 16
    tag: str = "compute"
    coll_kind: str = ""
    bytes: float = 0.0
    group: tuple = ()


class System:
    """A complete simulated machine, ready to replay device traces."""

    def __init__(self, spec: SystemSpec, parallel: bool = False,
                 deadline_s: float = None, scheduler=None,
                 max_workers: int = 4, fabric=None, executor=None) -> None:
        from ..fabric import make_fabric   # late: fabric imports core modules
        self.spec = spec
        if parallel:
            warnings.warn(
                "System(parallel=True) is deprecated; pass "
                "scheduler='batch' (or 'lookahead') instead",
                DeprecationWarning, stacklevel=2)
            if scheduler is None:
                scheduler = "batch"
        self.engine = Engine(scheduler=scheduler, max_workers=max_workers,
                             executor=executor)
        self.fabric = make_fabric(fabric or spec.fabric, spec)
        self.topology = self.fabric.topology
        self.programs: typing.List[DeviceProgram] = []
        self.cores: typing.List[TensorCore] = []
        self.hbms: typing.List[HbmController] = []
        self.coordinator = self.engine.register(
            CollectiveCoordinator("coordinator", deadline_s=deadline_s))
        self.fabric.install(self.engine, self.coordinator)
        # The coordinator fabric carries the only cross-chip traffic, so
        # its latency is what the lookahead scheduler's window derives
        # from: per-chip clusters may run ctrl_latency ahead of each other.
        coll_conn = self.engine.register(
            StarConnection("coll_fabric", self.coordinator.port("coll"),
                           latency_s=spec.ctrl_latency_s))
        for d in range(spec.total_chips):
            core = self.engine.register(TensorCore(f"chip{d}.core", spec.chip))
            hbm = self.engine.register(HbmController(f"chip{d}.hbm", spec.chip))
            prog = self.engine.register(DeviceProgram(f"chip{d}.prog", d))
            # on-chip wiring: program<->core, core->hbm
            self.engine.register(Connection(f"chip{d}.bus")).plug(
                prog.port("core")).plug(core.port("prog"))
            self.engine.register(Connection(f"chip{d}.membus")).plug(
                core.port("hbm")).plug(hbm.port("cpu"))
            coll_conn.plug(prog.port("coll"))
            self.programs.append(prog)
            self.cores.append(core)
            self.hbms.append(hbm)

    # ------------------------------------------------------------------
    def load_trace(self, runops: typing.List[_RunOp],
                   devices: typing.Iterable[int] = None) -> None:
        devs = list(devices) if devices is not None else range(len(self.programs))
        # Give the fabric advance notice of every planned collective:
        # transfer-level backends refine their bounded-lag edges from
        # the exact programs these will decompose into.
        for op in runops:
            if op.kind == "collective":
                for g in op.group:
                    if len(g) > 1:
                        self.fabric.note_plan(op.coll_kind, float(op.bytes),
                                              tuple(g))
        for d in devs:
            prog = self.programs[d]
            # per-device group resolution: pick the replica group containing d
            ops = []
            for op in runops:
                if op.kind == "collective":
                    group = next((g for g in op.group if d in g), None)
                    if group is None or len(group) <= 1:
                        continue  # this device does not participate
                    ops.append(dataclasses.replace(op, group=tuple(group)))
                else:
                    ops.append(op)
            prog.trace = ops

    def run(self, until_s: float = None) -> dict:
        for prog in self.programs:
            if prog.trace:
                prog.start()
        until_ps = s_to_ps(until_s) if until_s else None
        self.engine.run(until_ps)
        active = [p for p in self.programs if p.trace]
        finish = [p.finish_ps for p in active if p.done]
        return {
            "time_s": max(finish) / 1e12 if finish else 0.0,
            "devices_done": sum(p.done and not p.aborted for p in active),
            "devices_aborted": sum(p.aborted for p in active),
            "events": self.engine.events_processed,
            "collectives_completed": self.coordinator.completed,
            "collective_timeouts": len(self.coordinator.timed_out),
        }
