"""Fabric backend interface + the coordinator-facing controller protocol.

The interconnect is a pluggable subsystem (mirroring the scheduler
registry in ``repro.core.engine``): a :class:`FabricBackend` owns the
pricing/transport model for collectives, and every backend exposes it to
the :class:`~repro.core.system.CollectiveCoordinator` through the same
asynchronous protocol:

* ``System`` calls :meth:`FabricBackend.install`, which registers the
  backend's components (at minimum a :class:`FabricController`) on the
  engine and wires the coordinator's ``fabric`` port to the controller
  over a zero-latency connection -- the lookahead scheduler therefore
  fuses coordinator + controller into one sequential cluster, while the
  rest of a backend's component graph chooses its own cluster layout
  (the ``event`` backend rides a latency-carrying bus so its links and
  DMA engines parallelize; see ``repro.fabric.event``).
* When a replica group has fully joined, the coordinator sends a
  ``start`` request carrying ``(key, kind, bytes, group)``.
* The controller answers with a ``fabric_done`` request for the key when
  the transfer completes -- after one analytically priced delay
  (``analytic``) or after the last per-hop transfer event drains
  (``event``).

This keeps the coordinator completely ignorant of *how* collectives are
priced; swapping fidelity is a ``fabric=`` string, exactly like swapping
an engine scheduler.
"""
from __future__ import annotations

import typing

from ..core.component import Component
from ..core.connection import Connection, Request
from ..core.event import Event


class FabricController(Component):
    """Engine-registered entry point of a fabric backend.

    Receives ``start`` requests from the coordinator and must eventually
    reply ``fabric_done`` with the same key via :meth:`finish`.
    Subclasses implement :meth:`begin`.
    """

    def __init__(self, name: str, backend: "FabricBackend") -> None:
        super().__init__(name)
        self.backend = backend
        # per-kind traffic ledger: sum of nbytes * group fan-out over
        # every started collective, integer-accumulated so the totals
        # are independent of event-processing order (lives on the
        # controller so the procs executor's end-of-run state sync
        # carries it back, same idiom as the analytic link ledger)
        self.kind_bytes: typing.Dict[str, int] = {}
        self.collectives_started = 0

    def begin(self, key, kind: str, nbytes: float,
              group: typing.List[int]) -> None:
        raise NotImplementedError

    def finish(self, key) -> None:
        """Report collective completion back to the coordinator."""
        self.port("coord").send(Request(
            src=self.port("coord"), dst=None, kind="fabric_done",
            payload=key))

    def handle(self, event: Event) -> None:
        if event.kind == "request" and event.payload.kind == "start":
            key, kind, nbytes, group = event.payload.payload
            self.kind_bytes[kind] = (self.kind_bytes.get(kind, 0)
                                     + int(nbytes) * len(group))
            self.collectives_started += 1
            self.begin(key, kind, nbytes, group)


class FabricBackend:
    """Strategy object modeling the multi-chip interconnect.

    ``topology`` (a :class:`repro.core.topology.Topology`) provides the
    shared geometry -- coordinates, group classification, and the
    analytic formulas the ``analytic`` backend prices with and the
    ``event`` backend validates against.
    """

    name = "abstract"

    def __init__(self, spec) -> None:
        from ..core.topology import Topology  # late: avoid import cycle
        self.spec = spec
        self.topology = Topology(spec)
        self.controller: FabricController = None

    # -- wiring ----------------------------------------------------------
    def install(self, engine, coordinator) -> None:
        """Register backend components and wire the coordinator.

        One backend instance serves one ``System``: links and byte
        counters are per-install state, so reuse would mix dead
        components from an earlier engine into later reports.
        """
        if self.controller is not None:
            raise RuntimeError(
                f"fabric backend {self.name!r} is already installed; "
                "backend instances are single-use -- pass the fabric "
                "*name* to reuse the model in another System")
        self.controller = engine.register(self.make_controller())
        bus = engine.register(Connection("fabric.coord_bus"))
        bus.plug(coordinator.port("fabric"))
        bus.plug(self.controller.port("coord"))
        self._install_extra(engine)

    def make_controller(self) -> FabricController:
        raise NotImplementedError

    def _install_extra(self, engine) -> None:
        """Hook for backends that register more components (links, DMAs)."""

    def note_plan(self, kind: str, nbytes: float, group) -> None:
        """Advance notice of one planned collective (``System.load_trace``
        forwards the trace's ops).  Backends that derive bounded-lag
        synchronization structure from the workload override this; the
        default -- and the analytic backend -- ignore it."""

    # -- reporting / fault surface ---------------------------------------
    def fault_targets(self) -> typing.List[Component]:
        """Components a FaultInjector plan may address (e.g. links)."""
        return []

    def link_report(self) -> dict:
        return self.topology.link_report()

    def link_utilization(self, end_ps: int = None) -> dict:
        """Per-link busy fraction; only transfer-level backends have one."""
        return {}

    def traffic_report(self) -> dict:
        """Per-collective-kind byte totals (``nbytes * fan-out`` summed
        over started collectives) plus the start count.  Read through
        the controller so it survives the procs executor's shard
        residency; identical across backends for the same workload --
        it counts what was *asked* of the fabric, not how it moved."""
        if self.controller is None:
            return {}
        out = {"collectives_started": self.controller.collectives_started}
        for kind in sorted(self.controller.kind_bytes):
            out[kind] = self.controller.kind_bytes[kind]
        return out

    def describe(self) -> dict:
        return {"name": self.name}
