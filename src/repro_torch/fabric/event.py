"""Event-driven fabric backend: links and DMA engines as components.

Where the ``analytic`` backend prices a collective with one closed-form
evaluation, this backend *executes* it on the engine timeline:

* every directed ICI link, every pod DCN uplink and every pod bisection
  channel is a :class:`FabricLink` component with its own serialization
  queue (``busy_until_ps``) -- concurrent transfers on a shared link
  queue behind each other, which is exactly the contention the analytic
  formulas cannot express;
* every chip has a :class:`DmaEngine` component that walks the chip's
  per-hop transfer program (ring steps over the 2-D torus, hierarchical
  reduce over DCN) hop by hop;
* the :class:`EventController` decomposes each collective into those
  per-chip programs (:func:`decompose`) and reports completion when the
  last DMA engine drains.

The decomposition mirrors the analytic formulas step for step, so on an
uncongested single collective both backends agree to rounding error
(asserted in ``tests/test_fabric.py``); they diverge -- the event
backend slower, i.e. more faithful -- exactly when transfers overlap on
shared links (multi-tenant traces, concurrent cross-pod groups,
multi-hop collective-permutes through a common chip).

Fabric traffic rides the latency-carrying :class:`FabricXbar`: every
protocol leg (program dispatch, transfer request, ack/chunk return,
completion) is priced out of the step's own hop/DCN latency budget (see
:class:`Legs`), so no leg is zero-latency and the lookahead scheduler
does NOT fuse the fabric into one sequential cluster.  Instead each
chip's DMA engine plus its four ICI links form one cluster (via
``cluster_affinity``) and every DCN/bisection link is its own, letting
a windowed scheduler replay link traffic for distinct chips
concurrently.  The leg budget is carved so each step still totals
exactly ``bytes/bw + step_latency`` and a whole program's walltime is
identical to a zero-latency-bus replay -- parity with the analytic
oracle is preserved to ``s_to_ps`` rounding, and all schedulers remain
bit-identical (the commit-phase ordering argument in docs/engine.md).

Decompositions additionally carry the *consumer data dependency*
(delivered as ``chunk`` requests to the downstream DMA): each ring
step ``i+1`` waits for the chunks its two ring neighbors forwarded in
step ``i``; a ring all-to-all's single exchange step waits on both
neighbors the same way; and a collective-permute receiver closes with
an arrival gate fed by the final hop of its producer's store-and-
forward chain.  On a healthy fabric the chunks arrive exactly when the
consumers' own acks/gates fall due, so timing is unchanged; under a
degraded or transiently failed link the stall now propagates to every
data consumer -- a whole ring, both a2a neighbors, a permute receiver
-- instead of pinning only the sending chip's chain: the honest
failure mode.

Fault surface: links and DMA engines are ordinary components, so
``hooks.FaultInjector`` can degrade a *single link* by name (e.g.
``{"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 8.0)]}``) -- straggler
links, flapping ("transient") links, not just straggler chips.  See
docs/faults.md for the full plan grammar.
"""
from __future__ import annotations

import dataclasses
import typing

from ..core.component import Component
from ..core.connection import Connection, LagNode, Request
from ..core.event import Event
from ..core.hw import s_to_ps
from .base import FabricBackend, FabricController
from .plancache import cached_decompose


# -- per-chip transfer programs ----------------------------------------------

@dataclasses.dataclass(frozen=True)
class Xfer:
    """One transfer on one named link (parallel within a DmaStep).

    ``dst_chip`` names the consuming chip whose DMA engine receives the
    chunk (None for transfers without a modeled consumer, e.g. DCN or
    bisection aggregates): the link forwards a ``chunk`` notification
    there, which the consumer's matching step waits on.  ``dst_step``
    tags which of the consumer's steps banks the chunk; None means
    "same index as the producing step" (symmetric rings, where both
    programs advance in lockstep) -- multi-hop collective-permute paths
    of differing lengths set it explicitly.
    """
    link: str
    bytes: int
    dst_chip: typing.Optional[int] = None
    dst_step: typing.Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DmaStep:
    """Parallel transfers + a post-step latency (hop / DCN one-way).

    ``arrivals`` is the number of producer ``chunk`` notifications this
    step must collect (in addition to its own transfer acks) before the
    program may advance -- the collective data dependency.  A step with
    no transfers, zero latency and ``arrivals > 0`` is a pure *arrival
    gate* (a receiver waiting on inbound data, e.g. the closing step of
    a collective-permute consumer): it costs no simulated time of its
    own and completes the moment its chunks are banked.
    """
    xfers: tuple                  # tuple[Xfer, ...]; may be empty
    latency_ps: int = 0
    arrivals: int = 0


@dataclasses.dataclass(frozen=True)
class Legs:
    """Per-kind latency budget of the fabric bus (all integer ps).

    Every leg is carved out of the step latency it accompanies: a step
    costs ``xfer_ps`` on the request leg, ``bytes/bw`` serializing on
    the link, and ``latency_ps - xfer_ps`` on the ack/chunk leg -- so
    one step still totals ``bytes/bw + latency_ps``.  The final step's
    ack additionally absorbs ``exec_ps + done_ps``, cancelling the
    program-dispatch and completion legs: the whole program's walltime
    equals the zero-latency-bus replay exactly.  ``floor_ps`` (the
    xbar's ``min_latency_ps``, hence the lookahead window bound) is the
    minimum any leg may take; all four default to a quarter of the
    smallest link latency so even a one-step program (latency = one
    hop) fits ``exec + xfer + ack + done``.
    """
    exec_ps: int                  # controller -> DMA program dispatch
    xfer_ps: int                  # DMA -> link transfer request
    done_ps: int                  # DMA -> controller completion
    floor_ps: int                 # lower bound on any bus leg


ZERO_LEGS = Legs(0, 0, 0, 0)


def make_legs(topo) -> Legs:
    """Size the bus legs from the topology's smallest link latency.

    A zero hop latency degrades gracefully: all legs become zero, the
    xbar turns zero-latency and ``Engine.compute_clusters`` fuses the
    whole fabric back into one sequential cluster (the pre-latency
    behavior -- correct, just serial).
    """
    q = s_to_ps(topo.min_link_latency_s()) // 4
    return Legs(exec_ps=q, xfer_ps=q, done_ps=q, floor_ps=q)


class _Xmit:
    """Routing envelope for xfer / xfer_done / chunk requests on the
    fabric bus.  ``ack_ps`` is the connection latency of the returning
    ack AND of the forwarded neighbor chunk (computed by the issuing
    DMA from the step's latency budget); ``step`` tags which program
    step a chunk belongs to at the consuming neighbor.  One ``_Xmit``
    is allocated per transfer -- the densest payload on the fabric --
    so it is a bare ``__slots__`` class."""

    __slots__ = ("link", "chip", "key", "ack_ps", "dst_chip", "step")

    def __init__(self, link: str, chip: int, key: typing.Any,
                 ack_ps: int = 0, dst_chip: typing.Optional[int] = None,
                 step: int = 0) -> None:
        self.link = link
        self.chip = chip
        self.key = key
        self.ack_ps = ack_ps
        self.dst_chip = dst_chip
        self.step = step


def _dma_name(chip: int) -> str:
    return f"fabric.chip{chip}.dma"


def _ici(topo, device: int, dirn: str) -> str:
    pod, y, x = topo.coords(device)
    return f"fabric.pod{pod}.ici[{y},{x}]{dirn}"


# -- components ---------------------------------------------------------------

class FabricLink(Component):
    """A serialized, bandwidth-limited channel (ICI link, DCN uplink or
    bisection aggregate).  Transfers queue on ``busy_until_ps``; the
    FaultInjector's ``slow`` action stretches transfer durations (a
    degraded / straggler link), ``fail``/``transient`` drops transfers
    on the floor (they are never acked -- the sender, and with ring
    dependencies the whole ring, stalls)."""

    def __init__(self, name: str, bandwidth: float) -> None:
        super().__init__(name)
        self.bandwidth = bandwidth
        self.busy_until_ps = 0
        self.bytes_total = 0
        self.busy_ps = 0
        self.bus = self.port("bus")         # cached: hot on every transfer

    def handle(self, event: Event) -> None:
        now = event.time                    # == engine.now inside a handler
        if event.kind == "request":            # an xfer from a DMA engine
            req: Request = event.payload
            start = max(now, self.busy_until_ps)
            dur = s_to_ps(req.size_bytes / self.bandwidth
                          * self.fault_slow_factor)
            end = start + dur
            self.busy_until_ps = end
            self.bytes_total += req.size_bytes
            self.busy_ps += dur
            self.mark_busy(start, end, "xfer")
            self.schedule("xmit_done", end - now, payload=req.payload)
        elif event.kind == "xmit_done":
            xm: _Xmit = event.payload
            bus = self.bus
            bus.send(Request(src=bus, dst=None, kind="xfer_done",
                             payload=xm))
            if xm.dst_chip is not None:
                # ring data dependency: forward the chunk to the
                # consuming neighbor's DMA engine
                bus.send(Request(src=bus, dst=None, kind="chunk",
                                 payload=xm))


class DmaEngine(Component):
    """Walks per-collective hop programs for one chip: issue a step's
    transfers, wait for all of their acks plus any neighbor chunk
    arrivals the step declares, advance.  Multiple collectives
    (different keys) may be in flight at once -- their transfers contend
    on the links, not here.

    Step latency rides the bus legs (see :class:`Legs`), not a local
    timer: the ack returns ``latency_ps - xfer_ps`` after serialization,
    so the step still totals ``bytes/bw + latency_ps``.  A FaultInjector
    ``slow`` on this DMA engine stretches the step turnaround by
    ``(factor - 1) x latency`` on top (a straggling DMA issues hops more
    slowly), preserving the pre-latency fault arithmetic exactly.
    """

    def __init__(self, name: str, chip: int, legs: Legs = ZERO_LEGS) -> None:
        super().__init__(name)
        self.chip = chip
        self.legs = legs
        self.bus = self.port("bus")  # cached: hot on every step/ack
        self._progs: dict = {}     # key -> [steps, idx, final step idx]
        self._acks: dict = {}      # key -> outstanding xfer acks this step
        self._arrived: dict = {}   # (key, step idx) -> banked chunk count
        self._timed: set = set()   # keys waiting on a step_done timer

    def progress(self) -> dict:
        """Current step index per in-flight collective key (observable
        for ring-stall studies: a stalled ring shows every member pinned
        within one step of the faulted link's sender)."""
        return {key: prog[1] for key, prog in self._progs.items()}

    def handle(self, event: Event) -> None:
        if event.kind == "request":
            req: Request = event.payload
            if req.kind == "exec":
                _, key, steps = req.payload
                # The *final* step for walltime accounting is the last
                # one that costs simulated time (transfers or latency);
                # trailing arrival gates ride for free, so the exec/done
                # leg absorption stays on the step whose ack actually
                # closes the program's time budget.
                final = len(steps) - 1
                while final >= 0 and not (steps[final].xfers
                                          or steps[final].latency_ps > 0):
                    final -= 1
                self._progs[key] = [steps, 0, final]
                self._start_step(key)
            elif req.kind == "xfer_done":
                key = req.payload.key
                self._acks[key] -= 1
                self._maybe_finish_step(key)
            elif req.kind == "chunk":
                xm: _Xmit = req.payload
                slot = (xm.key, xm.step)
                self._arrived[slot] = self._arrived.get(slot, 0) + 1
                self._maybe_finish_step(xm.key)
        elif event.kind == "step_done":
            key = event.payload
            self._timed.discard(key)
            self._advance(key)

    def _maybe_finish_step(self, key) -> None:
        prog = self._progs.get(key)
        if prog is None or key in self._timed:
            return                 # late chunk for a finished/timed step
        steps, idx = prog[0], prog[1]
        if self._acks.get(key, 0) > 0:
            return
        step: DmaStep = steps[idx]
        if self._arrived.get((key, idx), 0) < step.arrivals:
            return                 # still waiting on ring neighbors
        self._arrived.pop((key, idx), None)
        extra = int(round(step.latency_ps * (self.fault_slow_factor - 1.0)))
        if extra > 0:              # straggling DMA: stretched turnaround
            self._timed.add(key)
            self.schedule("step_done", extra, payload=key)
        else:
            self._advance(key)

    def _advance(self, key) -> None:
        prog = self._progs[key]
        prog[1] += 1
        if prog[1] < len(prog[0]):
            self._start_step(key)
        else:
            del self._progs[key]
            self._acks.pop(key, None)
            for slot in [s for s in self._arrived if s[0] == key]:
                del self._arrived[slot]
            bus = self.bus
            bus.send(Request(src=bus, dst=None, kind="dma_done",
                             payload=(self.chip, key)))

    def _start_step(self, key) -> None:
        steps, idx, final_idx = self._progs[key]
        step: DmaStep = steps[idx]
        final = idx == final_idx
        legs = self.legs
        if not step.xfers:
            if step.arrivals and not step.latency_ps:
                # Arrival gate: no time of its own -- completes when the
                # producers' chunks are banked (possibly already).
                self._maybe_finish_step(key)
                return
            # Timed step (no transfers): the latency is waited locally; a
            # final timed step also absorbs the exec/done legs so program
            # walltime stays exact.
            residual = step.latency_ps - (legs.exec_ps + legs.done_ps
                                          if final else 0)
            self._timed.add(key)
            self.schedule(
                "step_done",
                max(0, int(round(residual * self.fault_slow_factor))),
                payload=key)
            return
        ack = step.latency_ps - legs.xfer_ps
        if final:
            ack -= legs.exec_ps + legs.done_ps
        ack = max(legs.floor_ps, ack)
        self._acks[key] = len(step.xfers)
        bus = self.bus
        for x in step.xfers:
            bus.send(Request(
                src=bus, dst=None, kind="xfer", size_bytes=int(x.bytes),
                payload=_Xmit(x.link, self.chip, key, ack, x.dst_chip,
                              idx if x.dst_step is None else x.dst_step)))


# -- bounded-lag refinement predicates (see FabricXbar.cluster_edges) --------

def _dispatch_pred(ev: Event) -> bool:
    """Controller-cluster events that may lead to an ``exec`` dispatch:
    everything *except* a pending ``dma_done`` completion (whose handler
    only does bookkeeping; a new dispatch needs a coordinator round trip
    first).  Unknown event shapes conservatively count."""
    p = ev.payload
    return not (ev.kind == "request" and isinstance(p, Request)
                and p.kind == "dma_done")


def _queued_xfer_pred(ranks: set):
    """Events at this cluster's links that have not serialized yet
    (transfer requests and anything else that is not an in-flight
    ``xmit_done``).  ``ranks`` is shared with the wire pred and keeps
    growing while the plan walk discovers the cluster's links."""
    def pred(ev: Event) -> bool:
        return ev.component.rank in ranks and ev.kind != "xmit_done"
    return pred


def _in_flight_pred(ranks: set):
    """Serializations already on the wire: their chunk/ack leaves after
    the step's ack leg, no serialization left to pay."""
    def pred(ev: Event) -> bool:
        return ev.kind == "xmit_done" and ev.component.rank in ranks
    return pred


class FabricXbar(Connection):
    """Routing bus for all fabric traffic.  Routing lives in the
    connection (DP-3): components address links / DMA engines / the
    controller by *name* in the request payload, never by reference.

    Unlike a plain Connection it prices each leg of the replay protocol
    individually (:class:`Legs`); ``min_latency_ps`` -- the bound the
    lookahead window derives from -- is the legs' common floor.  With a
    nonzero floor the xbar is never fused, so its endpoint clusters
    (chip DMA+links islands, DCN/bisection links, the controller) replay
    in parallel under windowed schedulers.
    """

    def __init__(self, name: str, controller, legs: Legs = ZERO_LEGS,
                 topology=None) -> None:
        super().__init__(name)
        self.controller = controller
        self.legs = legs
        self.topology = topology            # None -> clique cluster_edges
        self.registry: dict = {}
        # Shared reference to the backend's noted collective plans
        # (``EventFabric.note_plan``); non-empty -> trace-exact edges.
        self.plans = None

    @property
    def min_latency_ps(self) -> int:
        return self.legs.floor_ps

    def cluster_edges(self):
        """The xbar's true routing graph, instead of the default clique
        over its (many) endpoints.  Without this, one shared bus couples
        every fabric cluster to the global minimum time and bounded-lag
        horizons collapse back into the global barrier.

        Both modes route controller dispatch through a *gate* node: the
        controller's ``dma_done`` handler only completes bookkeeping and
        reports to the coordinator -- it never issues a new ``exec``
        directly, that always takes a full coordinator round trip over
        the collective star first (two control-latency hops).  Excluding
        pending completions from the dispatch bound is what lets a chip
        run deep into its DMA program while its own ``dma_done`` for the
        *previous* collective still sits at the controller.

        Without noted plans, edges mirror ``_resolve_dst`` /
        ``decompose`` conservatively:

        * gate -> each chip cluster (``exec``), chip -> controller
          (``dma_done``);
        * chip cluster <-> its pod's DCN / bisection links: ``xfer``
          requests out, ``xfer_done`` acks back;
        * per-pod chip clique at the leg floor: ring/a2a chunks go to
          torus neighbors, but collective-permute store-and-forward
          issues ``xfer`` on *any* link along an intra-pod torus path
          (and its ack returns from there), so the honest per-``xfer``
          reach inside a pod is every other chip.  Rings never leave a
          pod -- cross-pod traffic rides the DCN -- so no chip-to-chip
          edge crosses pods.

        With plans noted (``System.load_trace`` forwards every planned
        collective), the per-pod cliques are replaced by the exact
        per-link transfer graph of the planned programs -- see
        :meth:`_planned_edges`.  Collectives *not* noted while plans
        are in effect fail loudly at the strict-window guard, never
        silently: the declared edges stop being a superset of the
        traffic.
        """
        topo = self.topology
        if topo is None:                    # standalone xbar: default clique
            yield from super().cluster_edges()
            return
        legs = self.legs
        ctrl = self.controller.cluster_id
        registry = self.registry
        gate = LagNode("fabric.ctrl.dispatch", ctrl, pred=_dispatch_pred,
                       inherit_inputs=True)
        by_pod: dict = {}
        for d in range(topo.spec.total_chips):
            cid = registry[_dma_name(d)].cluster_id
            by_pod.setdefault(topo.coords(d)[0], []).append(cid)
            yield (gate, cid, legs.exec_ps)
            yield (cid, ctrl, legs.done_ps)
        if self.plans:
            yield from self._planned_edges()
            return
        for pod, chips in by_pod.items():
            pod_links = []
            for kind in ("dcn", "bisect"):
                link = registry.get(f"fabric.pod{pod}.{kind}")
                if link is not None:
                    pod_links.append(link.cluster_id)
            for cid in chips:
                for lid in pod_links:
                    yield (cid, lid, legs.xfer_ps)
                    yield (lid, cid, legs.floor_ps)
                for other in chips:
                    if other != cid:
                        yield (cid, other, legs.floor_ps)

    def _planned_edges(self):
        """Trace-exact link-level edges for the noted collective plans.

        Each plan is re-decomposed into its per-chip DMA programs (the
        same :func:`decompose` the controller will run), and every
        transfer contributes its true legs.  Per link *cluster* two
        refinement nodes split the two event classes a link holds:

        * ``queue`` -- transfer requests not yet serialized.  Before
          anything leaves the link they must serialize, so the only
          out-edge is ``queue -> wire`` at the minimum serialization
          time of any planned transfer on those links (``bytes / bw``;
          fault ``slow`` only stretches it).
        * ``wire`` -- in-flight serializations (``xmit_done``).  These
          ack the issuing DMA and hand ring chunks to the consuming
          neighbor no earlier than the step's ack leg.

        Splitting matters because a chip fuses with its own four ICI
        links: one node would bound the *neighbor's* horizon by the
        chip's earliest pending event + one ack, hiding the
        serialization the chunk still has to pay.
        """
        topo, legs, registry = self.topology, self.legs, self.registry
        qnode: dict = {}                    # link cluster -> queue LagNode
        wnode: dict = {}                    # link cluster -> wire LagNode
        lranks: dict = {}                   # link cluster -> link ranks (grows)
        mindur: dict = {}                   # link cluster -> min serialization
        edges: list = []
        for kind, nbytes, group in self.plans:
            for d, steps in cached_decompose(topo, kind, float(nbytes),
                                             list(group)).items():
                src = registry[_dma_name(d)].cluster_id
                final = len(steps) - 1
                while final >= 0 and not (steps[final].xfers
                                          or steps[final].latency_ps > 0):
                    final -= 1
                for idx, st in enumerate(steps):
                    if not st.xfers:
                        continue
                    # mirrors DmaEngine._start_step ack arithmetic
                    ack = st.latency_ps - legs.xfer_ps
                    if idx == final:
                        ack -= legs.exec_ps + legs.done_ps
                    ack = max(legs.floor_ps, ack)
                    for x in st.xfers:
                        link = registry[x.link]
                        lcid = link.cluster_id
                        ranks = lranks.get(lcid)
                        if ranks is None:
                            ranks = lranks[lcid] = set()
                            qnode[lcid] = LagNode(
                                f"links{lcid}.queue", lcid,
                                pred=_queued_xfer_pred(ranks))
                            wnode[lcid] = LagNode(
                                f"links{lcid}.wire", lcid,
                                pred=_in_flight_pred(ranks))
                        ranks.add(link.rank)
                        dur = s_to_ps(int(x.bytes) / link.bandwidth)
                        prev = mindur.get(lcid)
                        if prev is None or dur < prev:
                            mindur[lcid] = dur
                        edges.append((src, qnode[lcid], legs.xfer_ps))
                        edges.append((wnode[lcid], src, ack))
                        if x.dst_chip is not None:
                            edges.append(
                                (wnode[lcid],
                                 registry[_dma_name(x.dst_chip)].cluster_id,
                                 ack))
        for lcid, qn in qnode.items():
            edges.append((qn, wnode[lcid], mindur[lcid]))
        return edges

    def transfer_time_ps(self, request: Request) -> int:
        legs = self.legs
        if request.kind == "xfer":
            return legs.xfer_ps
        if request.kind in ("xfer_done", "chunk"):
            return request.payload.ack_ps
        if request.kind == "exec":
            return legs.exec_ps
        if request.kind == "dma_done":
            return legs.done_ps
        return legs.floor_ps

    def attach(self, component, port_name: str = "bus") -> None:
        self.plug(component.port(port_name))
        self.registry[component.name] = component

    def _resolve_dst(self, src_port, request: Request) -> None:
        if request.dst is not None:
            return
        if request.kind == "xfer":
            request.dst = self.registry[request.payload.link]
        elif request.kind == "xfer_done":
            request.dst = self.registry[_dma_name(request.payload.chip)]
        elif request.kind == "chunk":
            request.dst = self.registry[_dma_name(request.payload.dst_chip)]
        elif request.kind == "exec":
            request.dst = self.registry[_dma_name(request.payload[0])]
        elif request.kind == "dma_done":
            request.dst = self.controller


class EventController(FabricController):
    """Decomposes collectives into per-chip DMA programs and completes a
    key when every participating DMA engine reports done."""

    def __init__(self, name: str, backend: "EventFabric") -> None:
        super().__init__(name, backend)
        self._pending: dict = {}   # key -> DMAs still running

    def begin(self, key, kind: str, nbytes: float,
              group: typing.List[int]) -> None:
        # content-hashed plan cache: the same (topology, kind, bytes,
        # group) triple decomposes once per process (or once per sweep,
        # with the disk tier) -- the cached programs are read-only and
        # this filter copies into a fresh dict before use
        progs = cached_decompose(self.backend.topology, kind,
                                 float(nbytes), group)
        progs = {d: steps for d, steps in progs.items() if steps}
        if not progs:
            self.schedule("noop_done", 0, payload=key)
            return
        self._pending[key] = len(progs)
        for chip in sorted(progs):
            self.port("bus").send(Request(
                src=self.port("bus"), dst=None, kind="exec",
                payload=(chip, key, tuple(progs[chip]))))

    def handle(self, event: Event) -> None:
        if event.kind == "request" and event.payload.kind == "dma_done":
            _, key = event.payload.payload
            self._pending[key] -= 1
            if self._pending[key] == 0:
                del self._pending[key]
                self.finish(key)
        elif event.kind == "noop_done":
            self.finish(event.payload)
        else:
            super().handle(event)


# -- collective decomposition (mirrors topology.py's analytic formulas) ------

def _ring_neighbors(topo, members, axis: str) -> tuple:
    """Successor/predecessor maps along ``axis`` for the physical wrap
    rings the members form (rows keyed by the orthogonal coordinates).
    Members alone in their row -- e.g. cross-pod representatives whose
    closing exchange is not a physical ring -- get no neighbors and
    therefore no data dependency."""
    rows: dict = {}
    for d in members:
        pod, y, x = topo.coords(d)
        rows.setdefault((pod, y) if axis == "x" else (pod, x), []).append(d)
    succ: dict = {}
    pred: dict = {}
    for row in rows.values():
        if len(row) < 2:
            continue
        row.sort(key=lambda d: topo.coords(d)[2 if axis == "x" else 1])
        for i, d in enumerate(row):
            succ[d] = row[(i + 1) % len(row)]
            pred[d] = row[(i - 1) % len(row)]
    return succ, pred


def _ring_steps(topo, members, axis: str, B: float, phases: int,
                ring_n: int = None) -> dict:
    """Bidirectional ring: each step moves B/(2n) per direction per chip.
    ``phases*(n-1)`` steps of ``chunk/bw + hop`` reproduce ``_ring_time``.
    Each step carries the ring data dependency: the +axis chunk feeds
    the successor, the -axis chunk the predecessor, and the chip's next
    step waits for the matching chunks from both neighbors."""
    n = ring_n or len(members)
    hop = s_to_ps(topo.spec.chip.ici_hop_latency_s)
    chunk = int(round(B / (2 * n)))
    nsteps = phases * (n - 1)
    succ, pred = _ring_neighbors(topo, members, axis)
    out = {}
    for d in members:
        plus, minus = _ici(topo, d, "+" + axis), _ici(topo, d, "-" + axis)
        arrivals = (d in succ) + (d in pred)
        out[d] = [DmaStep((Xfer(plus, chunk, succ.get(d)),
                           Xfer(minus, chunk, pred.get(d))), hop, arrivals)
                  for _ in range(nsteps)]
    return out


def _block_steps(topo, members, m: int, B: float, phases: int) -> dict:
    """Hierarchical 2-D: x-ring phase with B, then y-ring with B/nx --
    the event-space image of ``_block2d_time``."""
    nx = min(topo.X, m)
    ny = max(1, m // nx)
    out = _ring_steps(topo, members, "x", B, phases, ring_n=nx)
    if ny > 1:
        for d, steps in _ring_steps(topo, members, "y", B / nx, phases,
                                    ring_n=ny).items():
            out[d] = out[d] + steps
    return out


def _merge(progs: dict, extra: dict) -> None:
    for d, steps in extra.items():
        progs[d] = progs.get(d, []) + steps


def _torus_path(topo, src: int, dst: int) -> typing.List[str]:
    """Directed link names along the x-then-y torus-shortest route."""
    pod, y, x = topo.coords(src)
    _, y2, x2 = topo.coords(dst)
    X, Y = topo.X, topo.Y
    links = []
    dx = (x2 - x) % X
    sx, nx = ("+x", dx) if dx <= X - dx else ("-x", X - dx)
    for _ in range(nx):
        links.append(f"fabric.pod{pod}.ici[{y},{x}]{sx}")
        x = (x + (1 if sx == "+x" else -1)) % X
    dy = (y2 - y) % Y
    sy, ny = ("+y", dy) if dy <= Y - dy else ("-y", Y - dy)
    for _ in range(ny):
        links.append(f"fabric.pod{pod}.ici[{y},{x}]{sy}")
        y = (y + (1 if sy == "+y" else -1)) % Y
    return links


def _cross_pod_steps(topo, kind: str, B: float, group) -> dict:
    """Hierarchical intra-pod + DCN exchange; mirrors ``_cross_pod_time``
    (with its n_groups=1 per-coordinator-call specialization).  The DCN
    transfer and any closing broadcast phase run on each pod's
    representative chip, so concurrent cross-pod groups queue on the
    shared :class:`FabricLink` DCN uplink -- the contention the analytic
    formula only models *within* one call's group list."""
    spec = topo.spec
    pods = spec.num_pods
    n = len(group)
    per_pod = max(1, n // pods)
    if kind == "all-reduce":
        eff = 2 * (pods - 1) / pods
    else:                          # ag / rs / a2a / permute, as analytic
        eff = (pods - 1) / pods
    by_pod: dict = {}
    for d in group:
        by_pod.setdefault(topo.coords(d)[0], []).append(d)
    progs = {d: [] for d in group}
    Bx = B
    if per_pod > 1:
        _merge(progs, _block_steps(topo, group, per_pod, B, 1))
        Bx = B / per_pod
    dcn_lat = s_to_ps(spec.chip.dcn_latency_s)
    dcn_bytes = int(round(Bx * eff))
    reps = []
    for pod in sorted(by_pod):
        rep = min(by_pod[pod])
        reps.append(rep)
        progs[rep] = progs[rep] + [DmaStep(
            (Xfer(f"fabric.pod{pod}.dcn", dcn_bytes),), dcn_lat)]
    if per_pod > 1 and kind in ("all-reduce", "all-gather"):
        _merge(progs, _block_steps(topo, reps, per_pod, B, 1))
    return progs


def decompose(topo, kind: str, B: float, group: typing.List[int]) -> dict:
    """Per-chip DMA programs for one collective over one replica group."""
    n = len(group)
    if n <= 1:
        return {}
    cls = topo.classify_group(group)
    spec = topo.spec
    c = spec.chip
    if cls == "cross_pod":
        return _cross_pod_steps(topo, kind, B, group)
    axis = "x" if cls == "ring_x" else "y"
    if kind == "all-reduce":
        return (_ring_steps(topo, group, axis, B, 2) if cls.startswith("ring")
                else _block_steps(topo, group, n, B, 2))
    if kind in ("all-gather", "reduce-scatter"):
        return (_ring_steps(topo, group, axis, B, 1) if cls.startswith("ring")
                else _block_steps(topo, group, n, B, 1))
    if kind == "all-to-all":
        if cls.startswith("ring"):
            # Single exchange step, but with the same consumer
            # dependency as the ring phases: each chip's step also waits
            # for its two neighbors' chunks, so a failed link stalls the
            # neighbors' programs, not just the sender's ack chain.  On
            # a healthy symmetric ring the chunks arrive exactly when
            # the chip's own acks do -- timing is unchanged.
            load = int(round(B * (n - 1) / 8))
            post = s_to_ps(n / 2 * c.ici_hop_latency_s)
            succ, pred = _ring_neighbors(topo, group, axis)
            return {d: [DmaStep(
                (Xfer(_ici(topo, d, "+" + axis), load, succ.get(d)),
                 Xfer(_ici(topo, d, "-" + axis), load, pred.get(d))),
                post, (d in succ) + (d in pred))]
                    for d in group}
        post = s_to_ps((topo.X / 2 + topo.Y / 2) * c.ici_hop_latency_s)
        return {d: [DmaStep(
            (Xfer(f"fabric.pod{topo.coords(d)[0]}.bisect",
                  int(round(B / 2))),), post)] for d in group}
    if kind == "collective-permute":
        # Store-and-forward chain per (src -> dst) pair, plus the
        # consumer dependency: the final hop forwards its chunk to the
        # destination's DMA, whose program closes with an arrival gate.
        # A fault anywhere on the path therefore stalls the *receiver*
        # too.  Healthy walltime is unchanged: the gate is free, the
        # chunk rides the final ack's own latency budget, and the
        # collective still completes with the slowest send chain.
        hop = s_to_ps(c.ici_hop_latency_s)
        progs = {d: [] for d in group}
        pairs = []
        for i, src in enumerate(group):
            dst = group[(i + 1) % n]
            if dst == src:
                continue
            pairs.append((src, dst))
            progs[src] = [DmaStep((Xfer(link, int(round(B))),), hop)
                          for link in _torus_path(topo, src, dst)]
        send_len = {d: len(progs[d]) for d in group}
        for src, dst in pairs:
            steps = progs[src]
            if not steps:
                continue
            last = steps[send_len[src] - 1]
            x = last.xfers[0]
            steps[send_len[src] - 1] = DmaStep(
                (Xfer(x.link, x.bytes, dst, send_len[dst]),),
                last.latency_ps)
            progs[dst].append(DmaStep((), 0, arrivals=1))
        return progs
    raise ValueError(f"unknown collective kind {kind!r}")


# -- the backend --------------------------------------------------------------

class EventFabric(FabricBackend):
    name = "event"

    def __init__(self, spec) -> None:
        super().__init__(spec)
        self.links: typing.List[FabricLink] = []
        self.dcn: typing.List[FabricLink] = []
        self.dmas: typing.List[DmaEngine] = []
        self.legs: Legs = make_legs(self.topology)
        self.xbar: FabricXbar = None
        self.plans: list = []               # noted (kind, bytes, group)
        self._plan_keys: set = set()

    def note_plan(self, kind: str, nbytes: float, group) -> None:
        """Record one planned collective (``System.load_trace`` calls
        this for every planned op).  Non-empty plans switch the xbar's
        bounded-lag edges from the conservative per-pod cliques to the
        exact link-level transfer graph of the planned programs; a
        collective that then runs *unplanned* trips the strict-window
        guard instead of corrupting determinism."""
        key = (kind, float(nbytes), tuple(group))
        if key not in self._plan_keys:
            self._plan_keys.add(key)
            self.plans.append(key)

    def make_controller(self) -> FabricController:
        return EventController("fabric.ctrl", self)

    def _install_extra(self, engine) -> None:
        spec = self.spec
        topo = self.topology
        legs = self.legs
        xbar = engine.register(
            FabricXbar("fabric.xbar", self.controller, legs, topology=topo))
        self.xbar = xbar
        xbar.plans = self.plans             # shared: later notes are seen
        xbar.attach(self.controller)
        for d in range(spec.total_chips):
            dma = engine.register(DmaEngine(_dma_name(d), d, legs))
            # one lookahead cluster per chip: the DMA engine and the
            # chip's own four ICI links (its dominant traffic partners)
            dma.cluster_affinity = f"fabric.chip{d}"
            self.dmas.append(dma)
            xbar.attach(dma)
            for dirn in ("+x", "-x", "+y", "-y"):
                link = FabricLink(_ici(topo, d, dirn),
                                  spec.chip.ici_link_bandwidth)
                link.cluster_affinity = f"fabric.chip{d}"
                self.links.append(engine.register(link))
                xbar.attach(link)
        for p in range(spec.num_pods):
            # pod-shared channels stay their own clusters: they are
            # contended by many chips and fusing them anywhere would
            # serialize that whole pod
            up = FabricLink(f"fabric.pod{p}.dcn", spec.dcn_bandwidth_per_pod)
            bis = FabricLink(f"fabric.pod{p}.bisect",
                             spec.bisection_bandwidth_per_pod)
            self.dcn.append(engine.register(up))
            self.links.append(engine.register(bis))
            xbar.attach(up)
            xbar.attach(bis)

    # -- fault / reporting surface ---------------------------------------
    def fault_targets(self):
        return self.links + self.dcn + self.dmas

    def link_report(self) -> dict:
        hot = sorted(self.links, key=lambda l: (-l.bytes_total, l.name))[:8]
        return {
            "hottest_links": [(l.name, float(l.bytes_total))
                              for l in hot if l.bytes_total],
            "dcn_bytes": [(l.name, float(l.bytes_total)) for l in self.dcn],
        }

    def link_utilization(self, end_ps: int = None) -> dict:
        if not end_ps:
            end_ps = max((l.busy_until_ps for l in self.links + self.dcn),
                         default=0)
        if not end_ps:
            return {}
        return {l.name: l.busy_ps / end_ps
                for l in self.links + self.dcn if l.busy_ps}
