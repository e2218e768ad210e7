"""Engine core + pluggable scheduler interface (copy of
``repro/core/engine/base.py`` for the port, which imports nothing of
``repro``).

The copy keeps the engine, the scheduler registry and the cluster
analysis; the round machinery (``_GroupCtx``, ``RoundScheduler``,
``_MergedCtx``) and the executor backends are cut, so the one scheduler
registered is ``serial``.  Asking for ``batch``, ``lookahead`` or
``bounded``, or for any executor, raises ``ValueError`` naming the later
slice that ports them (ROADMAP, open items).  The reference's text
follows.

Engine core + pluggable scheduler interface.

The engine owns the registered components, the global event queue, the
hook lists and the simulation clock; *how* events are drained is the job
of a :class:`Scheduler`.  Three ship with the repo:

* ``serial``     -- strict (time, rank, seq) order; the determinism oracle
  (:mod:`repro.core.engine.serial`).
* ``batch``      -- the paper's DP-5 conservative scheme: all events at
  the earliest timestamp run concurrently, grouped per component
  (:mod:`repro.core.engine.batch`).
* ``lookahead``  -- conservative PDES with a safe time window derived
  from the minimum cross-cluster connection latency; exploits
  parallelism even when per-component timestamps diverge
  (:mod:`repro.core.engine.lookahead`).

All three must produce bit-identical simulation results; the parametrized
determinism tests in ``tests/test_sim_engine.py`` assert it.  A fourth
scheduler is one :func:`register_scheduler` call away (see
``docs/engine.md``).

Thread-safety contract: during a round, worker threads post events
through a thread-local sink owned by the worker's own group context --
no shared mutable state.  Posts from *foreign* threads (or outside a
round) fall back to the global queue under ``_post_lock``; engine-level
hooks always fire under ``_hook_lock``.

Hot-path design (the allocation-lean event core):

* Events are ``__slots__`` objects stamped in place -- no
  ``dataclasses.replace`` copy per push.
* Registered items are guaranteed to carry ``rank`` / ``cluster_id`` /
  ``fault_failed`` (class-level defaults on Component/Connection), so
  dispatch reads plain attributes, never ``getattr`` fallbacks.
* Hook dispatch is gated on the cached ``hooks_active`` flag: a
  hook-free event pays one predicate check instead of four
  ``invoke_hooks`` calls.
* Round schedulers swap the engine's queue for a
  :class:`~repro.core.event.ShardedEventQueue` (one shard per cluster):
  windows pop per shard, already partitioned and sorted, and the commit
  phase routes posts per destination shard -- only *cross-cluster*
  traffic is ever merged, and then only with the posts of that one
  shard (see the seq-locality argument on ``ShardedEventQueue``).
* Per-cluster :class:`_GroupCtx` objects and the executor backend live
  for the whole ``run`` (reset, not reallocated, each round), with
  sticky ``cluster_id % workers`` worker assignment.

Round schedulers split *what* runs (window, grouping, commit order --
this module) from *where* it runs (an :class:`~repro.core.engine
.executor.Executor` backend): ``executor="threads"`` is the in-process
pool, ``executor="procs"`` pins each cluster to a long-lived worker
process with shard-resident component state.  See
:mod:`repro.core.engine.executor`.
"""
from __future__ import annotations

import threading
import typing
import warnings

from heapq import heapify as _heapify, heappop as _heappop, \
    heappush as _heappush

from ..connection import LagNode
from ..event import Event, EventQueue, LocalQueue, ShardedEventQueue
from ..hooks import Hookable, EVENT_START, EVENT_END

_INF = float("inf")                         # unbounded window / idle cluster


class LagGraph:
    """The bounded-lag synchronization graph at node granularity.

    The first ``n_clusters`` node indices are the clusters themselves
    (index == cluster id, base = the cluster's earliest pending event);
    indices beyond that are :class:`~repro.core.connection.LagNode`
    refinements whose base is the earliest pending event matching the
    node's predicate (``inf`` when nothing matches).  ``out`` feeds the
    earliest-input-time relaxation; ``horizon_in[c]`` holds only the
    *inter-cluster* in-edges that bound cluster ``c``'s horizon --
    intra-cluster node edges (e.g. a link's queued-transfer node to its
    in-flight node) participate in the relaxation but are not horizons
    themselves.
    """

    __slots__ = ("n_clusters", "n_nodes", "nodes_cluster", "out",
                 "horizon_in", "pred_scans", "plain_nodes")

    def __init__(self, n_clusters, nodes_cluster, out, horizon_in,
                 pred_scans, plain_nodes) -> None:
        self.n_clusters = n_clusters
        self.n_nodes = len(nodes_cluster)
        self.nodes_cluster = nodes_cluster  # node index -> cluster id
        self.out = out                      # node -> [(node, lat)]
        self.horizon_in = horizon_in        # cluster -> [(node, lat)]
        self.pred_scans = pred_scans        # [(cluster, [(node, pred)])]
        self.plain_nodes = plain_nodes      # pred-less nodes: [(node, cluster)]


def guarded_push(engine: "Engine", queue) -> typing.Callable:
    """A post sink that pushes straight onto ``queue`` (no foreign-post
    lock -- the caller's thread owns the run) while keeping the
    "cannot schedule into the past" causality assert.  Reads the clock
    through the thread-local directly, skipping the ``Engine.now``
    property on the hot path."""
    tls = engine._tls
    push = queue.push

    def sink(event: Event) -> None:
        t = getattr(tls, "now", None)
        assert event.time >= (engine._now_global if t is None else t), \
            "cannot schedule into the past"
        push(event)

    return sink


# -- scheduler interface + registry -----------------------------------------

class Scheduler:
    """Strategy object that drains an :class:`Engine`'s event queue.

    Subclasses implement :meth:`run`; they may assume exclusive use of
    the bound engine for the duration of the call.  ``run`` returns the
    timestamp of the last executed event (the simulation end time).
    """

    name = "abstract"

    def __init__(self, max_workers: int = 4) -> None:
        self.max_workers = max_workers
        self.engine: "Engine" = None

    def bind(self, engine: "Engine") -> "Scheduler":
        self.engine = engine
        return self

    def run(self, until_ps: int = None) -> int:
        raise NotImplementedError

    def describe(self) -> dict:
        return {"name": self.name, "max_workers": self.max_workers}


SCHEDULERS: dict = {}
# the reference's other schedulers, and where the port takes them up
_LATER_SCHEDULERS = ("batch", "lookahead", "bounded")
_LATER = ("the round schedulers, the thread executor and the event fabric "
          "come with a later slice (ROADMAP §1 item 2)")


def register_scheduler(name: str, factory) -> None:
    """Make ``Engine(scheduler=name)`` resolve to ``factory(max_workers=N)``."""
    SCHEDULERS[name] = factory


def make_scheduler(spec, max_workers: int = 4, executor=None) -> Scheduler:
    """Resolve a scheduler name (or pass through an instance).

    ``executor`` (name or :class:`~repro.core.engine.executor.Executor`
    instance) selects where round schedulers run grouped work; ``None``
    keeps the scheduler's default (``"threads"``).  The serial
    scheduler executes in-thread and ignores it.
    """
    if isinstance(spec, Scheduler):
        sched = spec
    else:
        try:
            factory = SCHEDULERS[spec]
        except KeyError:
            if spec in _LATER_SCHEDULERS:
                raise ValueError(
                    f"scheduler {spec!r} is not ported yet: the port has "
                    f"{sorted(SCHEDULERS)}; {_LATER}") from None
            raise ValueError(f"unknown scheduler {spec!r}; "
                             f"available: {sorted(SCHEDULERS)}") from None
        sched = factory(max_workers=max_workers)
    if executor is not None:
        raise ValueError(f"executor {executor!r}: the port has no executor "
                         f"backends (its serial scheduler runs in-thread); "
                         f"{_LATER}")
    return sched


# -- engine ------------------------------------------------------------------

class Engine(Hookable):
    def __init__(self, parallel: bool = False, max_workers: int = 4,
                 scheduler=None, executor=None) -> None:
        super().__init__()
        if parallel:
            warnings.warn(
                "Engine(parallel=True) is deprecated; pass "
                "scheduler='batch' (or 'lookahead') instead",
                DeprecationWarning, stacklevel=2)
        self.queue = EventQueue()
        self._now_global = 0
        self._tls = threading.local()
        self.parallel = parallel            # legacy knob; maps to 'batch'
        self.max_workers = max_workers
        self._components: list = []
        self._post_lock = threading.Lock()
        self._hook_lock = threading.RLock()
        self.events_processed = 0
        self.batch_widths: list = []        # events per execution round
        self.window_widths: list = []       # filled by windowed schedulers
        self.round_group_sizes: list = []   # per-round (cluster, events)
                                            # pairs (only when the scheduler
                                            # sets record_group_sizes; feeds
                                            # the architectural-speedup model
                                            # in benchmarks/fabric_contention)
        if scheduler is None:
            scheduler = "batch" if parallel else "serial"
        self.scheduler = make_scheduler(scheduler, max_workers=max_workers,
                                        executor=executor).bind(self)

    # -- clock ----------------------------------------------------------------
    @property
    def now(self) -> int:
        """Current simulation time.

        Inside an event handler this is the handled event's timestamp
        (thread-local, so concurrently executing groups each see their
        own local time); outside handlers it is the global clock.
        """
        t = getattr(self._tls, "now", None)
        return self._now_global if t is None else t

    @now.setter
    def now(self, value: int) -> None:
        self._now_global = value

    # -- registration ---------------------------------------------------------
    def register(self, item) -> typing.Any:
        """Register a component or connection; assigns deterministic rank.

        Every registered item is guaranteed a ``rank`` (and a
        ``cluster_id`` once a windowed scheduler runs), so queue and
        dispatch code reads them as plain attributes.
        """
        item.engine = self
        item.rank = len(self._components)
        self._components.append(item)
        return item

    # -- scheduling ------------------------------------------------------------
    def post(self, event: Event) -> None:
        # Sink paths guard against past-time posts themselves (the group
        # contexts assert against the executing event's timestamp), so
        # the hot path pays no ``self.now`` read per post.
        sink = getattr(self._tls, "sink", None)
        if sink is not None:
            sink(event)                     # this worker's own group context
        else:
            assert event.time >= self.now, "cannot schedule into the past"
            with self._post_lock:           # foreign thread / outside a round
                self.queue.push(event)

    # -- hooks ------------------------------------------------------------------
    def invoke_hooks(self, position: str, time: int, item) -> None:
        """Engine-level hooks are shared across worker threads -> locked."""
        if not self.hooks_active:
            return
        with self._hook_lock:
            Hookable.invoke_hooks(self, position, time, item)

    # -- execution ----------------------------------------------------------------
    def _handle_one(self, event: Event) -> None:
        """Run one event's handler with the clock pinned to its timestamp.

        The hook-free fast path (the overwhelmingly common case) is a
        single flag check; any attached hook -- engine- or
        component-level -- routes through the original four-position
        dispatch so tracers and fault injectors observe every event.
        """
        comp = event.component
        tls = self._tls
        prev = getattr(tls, "now", None)
        tls.now = event.time
        try:
            if self.hooks_active or comp.hooks_active:
                self._handle_hooked(event, comp)
            elif not comp.fault_failed:
                if event.kind != "notify_available":
                    comp.handle(event)
                else:
                    # DP-6 wake posted by a capacity-limited connection;
                    # dispatched to the dedicated callback so components
                    # need not pattern-match it inside handle().
                    comp.notify_available(event.payload)
            elif event.kind == "notify_available":
                # the waiter died holding a slot reservation: hand it back
                event.payload.reclaim(comp)
        finally:
            tls.now = prev

    def _handle_hooked(self, event: Event, comp) -> None:
        """Slow path: at least one hook observes this event."""
        self.invoke_hooks(EVENT_START, event.time, event)
        comp.invoke_hooks(EVENT_START, event.time, event)
        if not comp.fault_failed:
            if event.kind == "notify_available":
                comp.notify_available(event.payload)
            else:
                comp.handle(event)
        elif event.kind == "notify_available":
            event.payload.reclaim(comp)
        comp.invoke_hooks(EVENT_END, event.time, event)
        self.invoke_hooks(EVENT_END, event.time, event)

    def run(self, until_ps: int = None) -> int:
        """Drain the queue (or run past ``until_ps``) via the scheduler."""
        return self.scheduler.run(until_ps)

    # -- topology analysis (used by windowed schedulers) ---------------------
    def compute_clusters(self) -> typing.List[int]:
        """Partition registered items into sequential clusters.

        Two fusion rules feed one union-find:

        * A connection is *fused* with all its endpoint owners when its
          send path can create same-time cross-component events (zero
          latency) or mutates shared state senders race on
          (LinkConnection occupancy, attached hooks --
          ``Connection.stateful_send``).
        * Components sharing a non-None ``cluster_affinity`` key are
          fused with each other.  Affinity lets a subsystem declare its
          own sequential islands without wiring artificial zero-latency
          connections -- the event fabric groups each chip's DMA engine
          with that chip's four ICI links this way, so the dominant
          DMA<->own-link traffic stays intra-cluster while distinct
          chips (and the pod DCN/bisection links) parallelize.

        Components inside one cluster must execute sequentially; distinct
        clusters only interact through >= min-latency connections, which
        is what makes the lookahead window safe (fusing more is always
        safe, only slower).

        Returns cluster id per rank and annotates each registered item
        with ``item.cluster_id`` (also its event-queue shard).
        """
        n = len(self._components)
        parent = list(range(n))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(a: int, b: int) -> None:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        self._fused_connections: set = set()
        affinity_root: dict = {}
        for item in self._components:
            aff = item.cluster_affinity
            if aff is not None:
                union(affinity_root.setdefault(aff, item.rank), item.rank)
            endpoints = getattr(item, "endpoints", None)
            if endpoints is None:
                continue                    # not a connection
            zero_lat = getattr(item, "min_latency_ps", 0) <= 0
            if zero_lat or getattr(item, "stateful_send", False):
                self._fused_connections.add(item.rank)
                for port in endpoints:
                    union(item.rank, port.owner.rank)

        # normalize to dense ids ordered by lowest member rank
        ids: dict = {}
        clusters = []
        for rank in range(n):
            root = find(rank)
            cid = ids.setdefault(root, len(ids))
            clusters.append(cid)
            self._components[rank].cluster_id = cid
        return clusters

    def min_cross_cluster_latency_ps(self) -> typing.Optional[int]:
        """Smallest delay a non-fused connection can impose on a send.

        This is the auto-derived lookahead window: no event executed at
        time t can create a cross-cluster event before ``t + window``.
        ``None`` means no cross-cluster channels exist at all (the window
        is unbounded -- clusters never interact).
        """
        fused = getattr(self, "_fused_connections", set())
        best = None
        for item in self._components:
            if getattr(item, "endpoints", None) is None:
                continue
            if item.rank in fused:
                continue                    # intra-cluster only
            lat = getattr(item, "min_latency_ps", 0)
            if best is None or lat < best:
                best = lat
        return best

    def cluster_graph(self) -> "LagGraph":
        """Directed min-latency graph between clusters -- the bounded-lag
        synchronization graph.

        Where :meth:`min_cross_cluster_latency_ps` collapses the whole
        topology into one number (the global-barrier window), this keeps
        the structure: each non-fused connection declares which cluster
        pairs it can actually carry events between and at what minimum
        delay (:meth:`~repro.core.connection.Connection.cluster_edges`;
        shared buses override the clique default with their routing
        graph).  A cluster's safe horizon is then derived from its
        *in-neighbors* only, so clusters that never exchange events do
        not synchronize at all.

        Edge endpoints may be :class:`~repro.core.connection.LagNode`
        refinements: extra graph nodes covering only the events matching
        the node's predicate, so a connection can promise different
        minimum delays for different event classes within one cluster
        (see the :class:`FabricXbar` link queue/wire split).

        Must be called after :meth:`compute_clusters`.  Parallel edges
        collapse to their minimum; *inter-cluster* latencies clamp to
        >= 1 tick so every horizon strictly exceeds its inputs (progress
        guarantee), while intra-cluster node edges may carry 0.
        """
        fused = getattr(self, "_fused_connections", set())
        ncl = 0
        for item in self._components:
            if item.cluster_id >= ncl:
                ncl = item.cluster_id + 1
        nodes_cluster = list(range(ncl))    # default node per cluster
        preds: list = [None] * ncl
        node_ix: dict = {}                  # id(LagNode) -> node index
        inherit: list = []                  # (node, cluster, author rank)
        edges: list = []                    # (u, v, lat, author rank)

        def resolve(end, author):
            if not isinstance(end, LagNode):
                return end
            ix = node_ix.get(id(end))
            if ix is None:
                ix = len(nodes_cluster)
                node_ix[id(end)] = ix
                nodes_cluster.append(end.cluster)
                preds.append(end.pred)
                if end.inherit_inputs:
                    inherit.append((ix, end.cluster, author))
            return ix

        for item in self._components:
            if getattr(item, "endpoints", None) is None:
                continue
            if item.rank in fused:
                continue
            for src, dst, lat in item.cluster_edges():
                u = resolve(src, item.rank)
                v = resolve(dst, item.rank)
                if u != v:
                    edges.append((u, v, lat, item.rank))
        # A gate node only filters traffic its own connection understands;
        # whatever *other* connections aim at its cluster it must receive
        # unfiltered (copied onto the node, authorship-excluded).
        for ix, cluster, author in inherit:
            edges.extend((u, ix, lat, a) for (u, v, lat, a) in tuple(edges)
                         if v == cluster and a != author)
        best: dict = {}
        for u, v, lat, _a in edges:
            if nodes_cluster[u] != nodes_cluster[v]:
                if lat < 1:
                    lat = 1
            elif lat < 0:
                lat = 0
            key = (u, v)
            cur = best.get(key)
            if cur is None or lat < cur:
                best[key] = lat
        nn = len(nodes_cluster)
        out = [[] for _ in range(nn)]
        horizon_in = [[] for _ in range(ncl)]
        for (u, v), lat in sorted(best.items()):
            out[u].append((v, lat))
            cv = nodes_cluster[v]
            if nodes_cluster[u] != cv:
                horizon_in[cv].append((u, lat))
        by_cluster: dict = {}
        plain: list = []
        for ix in range(ncl, nn):
            if preds[ix] is not None:
                by_cluster.setdefault(nodes_cluster[ix], []).append(
                    (ix, preds[ix]))
            else:
                plain.append((ix, nodes_cluster[ix]))
        return LagGraph(ncl, nodes_cluster, out, horizon_in,
                        sorted(by_cluster.items()), plain)
