"""Request-connection system (paper Sec. 4.1, part 3).

Components communicate exclusively by sending :class:`Request` objects
over :class:`Connection` objects.  Connections model the transport --
on-chip fabric (zero/fixed latency), ICI links (latency + serialization
bandwidth + occupancy) and DCN (high latency, pod-aggregate bandwidth).

A connection is itself an engine-registered entity so that deliveries are
ordinary events: the connection schedules a ``deliver`` event addressed
to itself, and on handling it invokes the destination component's
``handle`` with a ``request`` event.  This keeps every state change on
the event timeline (DP-3/DP-4) and lets hooks observe all traffic.

DP-6 (no busy ticking): :class:`LimitedConnection` has a bounded queue;
when full, ``send`` returns ``False`` and the *connection* remembers the
rejected sender, notifying it via ``notify_available`` when space frees
-- senders never poll.
"""
from __future__ import annotations

import typing

from .component import Registered
from .event import Event
from .hooks import Hookable, REQ_SEND, REQ_DELIVER
from .hw import s_to_ps


class Request:
    """One message on a connection.  ``__slots__`` class: requests are
    the densest allocation after events themselves (every transfer, ack
    and chunk on the event fabric is one), so they carry no dict."""

    __slots__ = ("src", "dst", "kind", "size_bytes", "payload")

    def __init__(self, src: typing.Any = None, dst: typing.Any = None,
                 kind: str = "", size_bytes: int = 0,
                 payload: typing.Any = None) -> None:
        self.src = src             # Port
        self.dst = dst             # Component (resolved by the connection)
        self.kind = kind
        self.size_bytes = size_bytes
        self.payload = payload

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Request({self.kind}, {self.size_bytes}B)"


class LagNode:
    """One *refinement node* in the bounded-lag synchronization graph.

    ``Connection.cluster_edges`` may use a LagNode wherever a cluster id
    is expected.  A node belongs to ``cluster`` but represents only the
    subset of that cluster's pending events matched by ``pred`` (an
    ``Event -> bool`` predicate; ``None`` keeps the whole cluster), so
    out-edges leaving the node promise a minimum delay for *that event
    class only* -- e.g. "an in-flight serialization acks after >= ack_ps"
    vs. "a queued transfer request must first serialize".  This is how a
    connection states per-event-kind lookahead that the one-number
    cluster edge cannot express (see ``Engine.cluster_graph``).

    Soundness contract (the author's obligation, backstopped by the
    strict-window guard): every cross-cluster event the connection can
    create must be covered by *some* declared edge whose source node's
    base is <= the causing event's time -- a pred-node path only
    tightens the cover, it must never be the sole cover for traffic its
    pred does not match.

    ``inherit_inputs=True`` additionally copies every edge that *other*
    connections aim at this node's cluster onto the node itself: a gate
    that filters its own connection's inputs still conservatively
    receives everything arriving from connections it knows nothing
    about.
    """

    __slots__ = ("name", "cluster", "pred", "inherit_inputs")

    def __init__(self, name: str, cluster: int, pred=None,
                 inherit_inputs: bool = False) -> None:
        self.name = name
        self.cluster = cluster
        self.pred = pred
        self.inherit_inputs = inherit_inputs

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"LagNode({self.name}, cluster={self.cluster})"


class Connection(Registered, Hookable):
    """Point/multi-point transport with fixed latency (on-chip fabric).

    Connections are engine-registered items like components (the
    :class:`~repro.core.component.Registered` contract guarantees the
    rank / cluster / fault attributes the engine hot path reads)."""

    def __init__(self, name: str, latency_s: float = 0.0) -> None:
        super().__init__()
        self.name = name
        self.latency_ps = s_to_ps(latency_s)
        self.endpoints: list = []

    # -- wiring -------------------------------------------------------------
    def plug(self, port) -> "Connection":
        port.connection = self
        self.endpoints.append(port)
        return self

    # -- scheduler interface -------------------------------------------------
    @property
    def min_latency_ps(self) -> int:
        """Lower bound on the delay any send imposes before the
        destination can observe it; the lookahead window derives from the
        minimum of this over all registered connections."""
        return self.latency_ps

    @property
    def stateful_send(self) -> bool:
        """True when concurrent sends race on shared state, so a windowed
        scheduler must fuse this connection with its endpoint owners into
        one sequential cluster.  A plain connection's send only posts
        events -- unless hooks are attached, which observe send order."""
        return self.hooks_active

    def cluster_edges(self) -> typing.Iterable[tuple]:
        """Directed cluster-graph edges this connection can carry events
        over: ``(src, dst, min_latency_ps)`` triples whose endpoints are
        cluster ids or :class:`LagNode` refinement nodes.

        The bounded-lag scheduler derives each cluster's safe horizon
        from the union of these edges over all non-fused connections
        (see ``Engine.cluster_graph``), so the declaration must be a
        *superset* of the traffic the connection can actually create --
        under-declaring an edge makes the strict-window guard raise at
        the first unsafe post, never silently corrupt determinism.

        The default is the conservative clique over the endpoint
        owners' clusters at ``min_latency_ps``: correct for any
        connection, but shared many-endpoint connections should
        override it with their true routing graph (see
        ``StarConnection`` and ``FabricXbar``) -- a clique through one
        shared bus couples every cluster to the global minimum and
        degenerates bounded lag back into the global barrier.

        Only called after ``Engine.compute_clusters`` has annotated
        ``cluster_id``; self-edges are ignored by the consumer.
        """
        lat = self.min_latency_ps
        cids = sorted({p.owner.cluster_id for p in self.endpoints})
        for a in cids:
            for b in cids:
                if a != b:
                    yield (a, b, lat)

    # -- protocol -----------------------------------------------------------
    def can_accept(self, src_port) -> bool:
        return True

    def transfer_time_ps(self, request: Request) -> int:
        return self.latency_ps

    def _resolve_dst(self, src_port, request: Request) -> None:
        """Point-to-point convenience: with exactly two endpoints the
        destination is implied (requests stay addressed, components keep
        zero references to peers)."""
        if request.dst is None and len(self.endpoints) == 2:
            a, b = self.endpoints
            request.dst = b.owner if a is src_port else a.owner

    def _post_transfer(self, request: Request, arrival_ps: int) -> None:
        """Scheduler-safe commit path: both the connection's deliver event
        and the destination's request event are posted *at send time*, a
        full ``transfer_time >= min_latency_ps`` ahead.  This keeps every
        cross-component event creation behind the connection's latency --
        the invariant the lookahead window is derived from (the old
        deliver-then-dispatch chain created the destination event with
        zero delay from the deliver event, which would force the window
        to zero).

        The deliver event exists purely so connection-attached hooks can
        observe arrival (``REQ_DELIVER``); on a hook-free connection it
        is skipped, halving the event volume on busy transports like the
        event fabric's bus.  (``LimitedConnection`` overrides this: its
        deliver event is load-bearing slot bookkeeping.)"""
        if self.hooks_active:
            self.engine.post(Event(time=arrival_ps, component=self,
                                   kind="deliver", payload=request))
        self.engine.post(Event(time=arrival_ps, component=request.dst,
                               kind="request", payload=request))

    def send(self, src_port, request: Request) -> bool:
        self._resolve_dst(src_port, request)
        if self.hooks_active:
            self.invoke_hooks(REQ_SEND, self.engine.now, request)
        self._post_transfer(request,
                            self.engine.now + self.transfer_time_ps(request))
        return True

    # -- engine interface (connections are event handlers too) ---------------
    def handle(self, event: Event) -> None:
        if event.kind == "deliver":
            # bookkeeping/observation only; the destination's request
            # event was posted at send time (see _post_transfer)
            self.invoke_hooks(REQ_DELIVER, self.engine.now, event.payload)

    def notify_available(self, connection) -> None:  # pragma: no cover
        pass

    def reclaim(self, waiter) -> None:  # pragma: no cover
        """Release any wake reservation held by ``waiter``.  Called by the
        engine when a ``notify_available`` event could not be delivered
        (the waiter failed) so the slot is not stranded.  Default: no-op."""


class LinkConnection(Connection):
    """Bandwidth-limited, serialized link (one message at a time).

    Transfer completes at ``max(now, busy_until) + latency + bytes/bw``.
    Occupancy is tracked so MetricsHook can report per-link utilisation.
    """

    def __init__(self, name: str, bandwidth: float, latency_s: float = 0.0) -> None:
        super().__init__(name, latency_s)
        self.bandwidth = bandwidth           # bytes/s
        self.busy_until_ps = 0
        self.bytes_total = 0

    @property
    def stateful_send(self) -> bool:
        # senders serialize on busy_until_ps -> must share their cluster
        return True

    def serialization_ps(self, size_bytes: int) -> int:
        return s_to_ps(size_bytes / self.bandwidth) if self.bandwidth else 0

    def send(self, src_port, request: Request) -> bool:
        self._resolve_dst(src_port, request)
        if self.hooks_active:
            self.invoke_hooks(REQ_SEND, self.engine.now, request)
        start = max(self.engine.now, self.busy_until_ps)
        done = start + self.serialization_ps(request.size_bytes)
        self.busy_until_ps = done
        self.bytes_total += request.size_bytes
        self._post_transfer(request, done + self.latency_ps)
        return True


class LimitedConnection(LinkConnection):
    """LinkConnection with a bounded in-flight queue (DP-6 notification)."""

    def __init__(self, name: str, bandwidth: float, latency_s: float = 0.0,
                 capacity: int = 4) -> None:
        super().__init__(name, bandwidth, latency_s)
        self.capacity = capacity
        self.in_flight = 0
        self._waiting: list = []   # rejected sender components, FIFO
        self._promised: list = []  # woken waiters holding a slot reservation

    def can_accept(self, src_port) -> bool:
        free = self.capacity - self.in_flight
        if src_port.owner in self._promised:
            return free > 0
        # slots reserved for already-woken waiters are off limits: the
        # wake travels as a posted event, so without the reservation a
        # same-timestamp sender could steal the slot and starve the FIFO
        return free > len(self._promised)

    def send(self, src_port, request: Request) -> bool:
        owner = src_port.owner
        if not self.can_accept(src_port):
            # reject and remember who to notify -- the sender must NOT retry
            # every cycle; it will get a notify_available callback.
            if owner not in self._waiting and owner not in self._promised:
                self._waiting.append(owner)
            return False
        if owner in self._promised:
            self._promised.remove(owner)
        self.in_flight += 1
        return super().send(src_port, request)

    def _post_transfer(self, request: Request, arrival_ps: int) -> None:
        # Only the deliver event is posted at send time: the freed slot
        # must be visible BEFORE the destination handles the arrival (its
        # handler may reply on this very connection), so the request
        # event is dispatched from the deliver handler instead.  That
        # zero-delay cross-component post is safe here because a
        # stateful connection is always fused with its endpoint owners
        # into one sequential cluster.
        self.engine.post(Event(time=arrival_ps, component=self,
                               kind="deliver", payload=request))

    def handle(self, event: Event) -> None:
        if event.kind == "deliver":
            request: Request = event.payload
            self.in_flight -= 1
            if self.hooks_active:
                self.invoke_hooks(REQ_DELIVER, event.time, request)
            self.engine.post(Event(time=event.time,
                                   component=request.dst, kind="request",
                                   payload=request))
            # wake exactly one waiter per freed slot, deterministically
            # FIFO.  The wake is a posted *notification event*, not a
            # synchronous call from this handler: the waiter re-enters
            # through the ordinary event loop (the engine dispatches
            # kind="notify_available" to Component.notify_available), so
            # a waiter may in principle live in another scheduler
            # cluster.  (Today LimitedConnection is stateful_send and
            # therefore fused with its endpoint owners anyway, which is
            # what makes the same-timestamp post window-safe.)  The freed
            # slot is *reserved* for the woken waiter until its next send
            # -- events between the wake and its delivery cannot steal it.
            self._wake_next()
        else:  # pragma: no cover
            super().handle(event)

    def _wake_next(self) -> None:
        if self._waiting and \
                self.in_flight + len(self._promised) < self.capacity:
            waiter = self._waiting.pop(0)
            self._promised.append(waiter)
            self.engine.post(Event(time=self.engine.now,
                                   component=waiter,
                                   kind="notify_available",
                                   payload=self))

    def reclaim(self, waiter) -> None:
        """A promised waiter died before its wake arrived: release the
        reservation and pass the slot to the next FIFO waiter, so a dead
        component cannot strand idle capacity."""
        if waiter in self._promised:
            self._promised.remove(waiter)
        if waiter in self._waiting:
            self._waiting.remove(waiter)
        self._wake_next()
