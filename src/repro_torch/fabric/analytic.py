"""Analytic fabric backend: closed-form collective pricing.

The fast path and the parity oracle.  Today's ring / hierarchical /
bisection formulas live in :class:`repro.core.topology.Topology`
(validated against hand-computed micro-benchmarks in
``tests/test_sim_topology.py``); this backend prices each collective
with a closed-form formula and schedules a single completion event --
O(1) events per collective, no link state, no contention: two
collectives sharing a link are priced as if each had it to itself.
When that fidelity gap matters, switch to the ``event`` backend
(:mod:`repro.fabric.event`).

Batched pricing: SPMD traces complete many replica groups at the same
simulated instant (every x-ring of a 256-chip all-reduce joins
together), and pricing each group through its own Python formula walk
is the per-event tax the vectorized fast path removes.  The controller
therefore *defers* each ``start`` by one zero-delay flush event,
collects every start sharing that timestep, and prices the whole batch
with one :func:`repro.fabric.pricing.price_collectives` call --
bit-equal to the scalar formulas (asserted in ``tests/test_pricing.py``
and by the ``batch_pricing=False`` identity test in
``tests/test_fabric.py``), so completion timestamps, link debits and
every ``SimReport`` field are unchanged.
"""
from __future__ import annotations

import typing

from ..core.event import Event
from ..core.hw import s_to_ps
from . import pricing
from .base import FabricBackend, FabricController


class AnalyticController(FabricController):
    """Prices collectives with the topology formulas and replies after
    the computed delay.  Also debits the topology's per-link byte
    counters (the analytic occupancy report).

    With ``backend.batch_pricing`` (the default), same-timestep starts
    are accumulated and priced in one vectorized call; otherwise each
    start is priced scalar and immediately -- both paths are bit-equal.
    """

    def __init__(self, name: str, backend: "AnalyticFabric") -> None:
        super().__init__(name, backend)
        self._pending: list = []       # same-timestep starts awaiting flush
        self._flush_at: int = -1       # timestep a flush is scheduled for
        self._class_memo: dict = {}    # group tuple -> class code
        self.batched_pricings = 0      # collectives priced via vector calls
        self.flushes = 0               # vectorized flush rounds

    def begin(self, key, kind: str, nbytes: float,
              group: typing.List[int]) -> None:
        if not self.backend.batch_pricing:
            t = self.backend.topology.collective_time_s(kind, nbytes, [group])
            self.schedule("xfer_complete", s_to_ps(t), payload=key)
            return
        self._pending.append((key, kind, nbytes, group))
        if self._flush_at != self.engine.now:
            self._flush_at = self.engine.now
            self.schedule("price_flush", 0)

    def _flush(self) -> None:
        pending, self._pending = self._pending, []
        self._flush_at = -1
        topo = self.backend.topology
        if len(pending) == 1:
            # a lone start gains nothing from array dispatch overhead
            key, kind, nbytes, group = pending[0]
            t = topo.collective_time_s(kind, nbytes, [group])
            self.schedule("xfer_complete", s_to_ps(t), payload=key)
            return
        times = pricing.price_collectives(
            topo, [(kind, nbytes, tuple(group))
                   for _, kind, nbytes, group in pending],
            memo=self._class_memo)
        for (key, kind, nbytes, group), t in zip(pending, times):
            topo.debit_links(kind, nbytes, [group])
            self.schedule("xfer_complete", s_to_ps(float(t)), payload=key)
        self.batched_pricings += len(pending)
        self.flushes += 1

    def handle(self, event: Event) -> None:
        if event.kind == "xfer_complete":
            self.finish(event.payload)
        elif event.kind == "price_flush":
            self._flush()
        else:
            super().handle(event)


class AnalyticFabric(FabricBackend):
    name = "analytic"

    def __init__(self, spec, batch_pricing: bool = True) -> None:
        super().__init__(spec)
        self.batch_pricing = batch_pricing

    def make_controller(self) -> FabricController:
        return AnalyticController("fabric.ctrl", self)

    def link_report(self) -> dict:
        # Under the procs executor the controller is shard-resident: the
        # worker debits *its replica's* backend.topology, and end-of-run
        # sync replaces controller.backend with that replica.  Read the
        # report through the controller so the debits survive shard
        # residency (the parent-held self.topology stays pristine there).
        if self.controller is not None:
            return self.controller.backend.topology.link_report()
        return self.topology.link_report()

    def describe(self) -> dict:
        d = super().describe()
        d["batch_pricing"] = self.batch_pricing
        if self.controller is not None:
            d["batched_pricings"] = self.controller.batched_pricings
            d["pricing_flushes"] = self.controller.flushes
        return d
