"""Component system (paper Sec. 4.1, part 2).

Every simulated entity is a :class:`Component`: a TPU TensorCore, an HBM
controller, an ICI router, a collective coordinator, ...  Strict state
encapsulation is the core design rule (DP-2/DP-3):

* a component's state is mutated **only** inside its own ``handle``;
* a component may only schedule events **for itself**
  (:meth:`Component.schedule` hard-codes ``component=self``);
* all inter-component communication goes through
  :class:`repro.core.connection.Connection` objects via ``Request``s.

There is deliberately **no** registry of "other components" on a
component -- it holds only :class:`Port` handles, so it is impossible to
reach across and poke another component's state ("no magic").
"""
from __future__ import annotations

import typing

from .event import Event
from .hooks import Hookable


class Port:
    """One endpoint of a connection, owned by a single component."""

    def __init__(self, owner: "Component", name: str) -> None:
        self.owner = owner
        self.name = name
        self.connection = None  # wired by Connection.plug

    def send(self, request) -> bool:
        if self.connection is None:
            raise RuntimeError(f"port {self.owner.name}.{self.name} is not wired")
        return self.connection.send(self, request)

    def can_send(self) -> bool:
        return self.connection is not None and self.connection.can_accept(self)


class Registered:
    """Contract of an engine-registered item (components *and*
    connections).  These attributes live at class level so every
    registered item is *guaranteed* to carry them -- the engine hot path
    reads ``rank``/``cluster_id``/``fault_failed`` with plain attribute
    access, no getattr fallbacks -- while hook-free, fault-free
    instances pay no per-instance storage.  Any new registrable type
    must mix this in (``Engine.register`` writes ``engine``/``rank``;
    ``Engine.compute_clusters`` writes ``cluster_id``)."""

    # -- shard residency (the ``procs`` executor contract) ---------------
    # Under a process-backed executor each cluster's components live in
    # one long-lived worker process for the whole run: handlers mutate
    # the *worker's* replica, and only compact per-round messages cross
    # the process boundary.  At the end of the run the worker ships each
    # component's mutable state back so the parent replica is faithful
    # again.  ``shard_state`` defines what ships: by default everything
    # in ``__dict__`` except the names in ``shard_state_skip``.
    # References to other registered items / ports / the engine survive
    # the trip as ranks (see ``engine.executor.wire``), so object
    # identity with the parent's graph is preserved.  Items that keep
    # mutable state outside ``__dict__`` (``__slots__`` subclasses) or
    # hold unpicklable values must override these two methods.
    shard_state_skip: frozenset = frozenset(("_hooks",))

    def shard_state(self) -> dict:
        """Mutable state a shard worker must ship back to the parent."""
        skip = self.shard_state_skip
        return {k: v for k, v in self.__dict__.items() if k not in skip}

    def apply_shard_state(self, state: dict) -> None:
        """Adopt state shipped back from this item's shard worker."""
        self.__dict__.update(state)

    engine = None               # set by Engine.register
    rank = 0                    # set by Engine.register (deterministic)
    cluster_id = 0              # set by Engine.compute_clusters: the
                                # sequential-execution group (and event-queue
                                # shard) a windowed scheduler assigns this
                                # item to
    cluster_affinity = None     # optional group key: items sharing a
                                # non-None affinity are fused into one
                                # cluster even without a fusing connection
                                # (subsystems declare their own sequential
                                # islands, e.g. the event fabric's chip
                                # DMA + links)
    # Fault-injection inputs (written by FaultInjector hook, read by the
    # item's own handler / the engine dispatch):
    fault_failed = False
    fault_slow_factor = 1.0


class Component(Registered, Hookable):
    def __init__(self, name: str) -> None:
        super().__init__()
        self.name = name
        self.ports: dict = {}

    # -- wiring -----------------------------------------------------------
    def port(self, name: str) -> Port:
        if name not in self.ports:
            self.ports[name] = Port(self, name)
        return self.ports[name]

    # -- scheduling (self only) -------------------------------------------
    def schedule(self, kind: str, delay_ps: int = 0, payload: typing.Any = None) -> None:
        """Schedule an event for *this* component ``delay_ps`` in the future."""
        assert delay_ps >= 0, "cannot schedule into the past"
        self.engine.post(Event(time=self.engine.now + delay_ps,
                               component=self, kind=kind, payload=payload))

    # -- behaviour ---------------------------------------------------------
    def handle(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def notify_available(self, connection) -> None:
        """Invoked when a capacity-limited connection frees up (DP-6:
        components never poll; they are notified).  Delivered as a posted
        ``notify_available`` event on the timeline -- the engine routes it
        here -- so waiters may live in other scheduler clusters.
        Default: no-op."""

    # -- convenience --------------------------------------------------------
    def mark_busy(self, start_ps: int, end_ps: int, tag: str) -> None:
        """Report a busy interval to hooks (metrics / utilization)."""
        if self.hooks_active:
            self.invoke_hooks("busy_interval", end_ps,
                              (self, start_ps, end_ps, tag))
        eng = self.engine
        if eng is not None and eng.hooks_active:
            eng.invoke_hooks("busy_interval", end_ps,
                             (self, start_ps, end_ps, tag))

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__} {self.name}>"
