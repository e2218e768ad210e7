"""Engine core + pluggable scheduler interface (copy of
``repro/core/engine/base.py`` for the port, which imports nothing of
``repro``; verbatim but for this paragraph).  The reference's text
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
from .executor import make_executor

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
            raise ValueError(f"unknown scheduler {spec!r}; "
                             f"available: {sorted(SCHEDULERS)}") from None
        sched = factory(max_workers=max_workers)
    if executor is not None:
        sched.executor_spec = executor
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


# -- shared round machinery ---------------------------------------------------

class _GroupCtx:
    """One cluster's execution context, reused across every round.

    Owns a local heap (the cluster's slice of the window plus events its
    handlers push back into it) and a post log whose stamps reproduce the
    order a serial engine would have posted in: (executing event's time,
    snapshot generation, rank, seq, intra-handler index) -- generation
    first among same-time events because serial runs a full snapshot
    round across *all* ranks before any of that round's delay-0 posts.
    Group execution is single-threaded, so none of this needs locks.

    The context is long-lived (allocated once per cluster in
    ``RoundScheduler.prepare``): :meth:`begin` resets it for a round by
    adopting the cluster's shard slice wholesale.
    """

    __slots__ = ("sched", "group_id", "window_end", "horizons", "local",
                 "posts", "executed", "max_time", "_adopted", "_entry",
                 "_post_idx", "_defer", "_strict")

    _IDLE_ENTRY = (0, 0, 0, 0, None)

    def __init__(self, sched: "RoundScheduler", group_id: int) -> None:
        self.sched = sched
        self.group_id = group_id
        self.window_end = 0
        # Per-cluster safe horizons of the current bounded-lag wave
        # (shared list, indexed by cluster id); None under a global
        # barrier, where every cluster shares this context's window_end.
        self.horizons = None
        self.local = LocalQueue()           # in-window posts only (side heap)
        self.posts: list = []               # (entry stamp, idx, event)
        self.executed = 0
        self.max_time = 0
        self._adopted: list = []            # this round's shard slice
        self._entry = self._IDLE_ENTRY      # executing event's heap entry
        self._post_idx = 0
        self._defer = sched.defer_all_posts
        self._strict = sched.strict_window

    def begin(self, window_end, entries: list) -> None:
        """Reset for a new round, adopting the cluster's popped shard
        slice (ascending (time, gen, rank, seq, event) entries).  The
        slice is *iterated in place* during :meth:`execute`; only events
        handlers push back into the window go through the side heap, so
        the common no-local-post round re-pops nothing.

        ``_post_idx`` resets per round, not per event: the commit stamp
        (entry, idx) only ever tie-breaks posts of the *same* executing
        event, so any monotonic idx sequence within the round works.
        """
        self.window_end = window_end
        self._adopted = entries
        self.local.clear()
        self.max_time = 0
        self._post_idx = 0

    def post(self, event: Event) -> None:
        assert event.time >= self._entry[0], "cannot schedule into the past"
        idx = self._post_idx
        self._post_idx = idx + 1
        if event.time < self.window_end:    # in-window: local or unsafe
            if (not self._defer
                    and event.component.cluster_id == self.group_id):
                # Same-timestamp posts inherit creator generation + 1 so
                # they wait for the next snapshot round, like serial;
                # later timestamps start fresh at generation 0.  No stamp
                # needed: local events never reach the commit phase.
                e = self._entry
                self.local.push_new(
                    event, generation=e[1] + 1 if event.time == e[0] else 0)
                return
            if (self._strict
                    and event.component.cluster_id != self.group_id):
                # Global barrier: any cross-cluster post inside the
                # shared window is unsafe.  Bounded lag: unsafe only
                # below the *target's* horizon -- own-window arrival is
                # legitimate when the target lags behind this cluster.
                h = self.horizons
                if h is None or event.time < h[event.component.cluster_id]:
                    self._unsafe_post(event)
        elif self._strict and self.horizons is not None:
            # Beyond own window but possibly below the target's horizon:
            # reachable only through an edge the connection failed to
            # declare in ``cluster_edges`` (or a send cheating its own
            # ``min_latency_ps``) -- fail loudly, never corrupt.
            cid = event.component.cluster_id
            if cid != self.group_id and event.time < self.horizons[cid]:
                self._unsafe_post(event)
        # The executing event's heap entry doubles as the post stamp:
        # (entry, idx) sorts exactly like the serial post order
        # (time, gen, rank, seq, intra-handler index), and the tuple
        # comparison can never reach the entry's event field because
        # seqs are unique -- zero allocations beyond the triple.
        self.posts.append((self._entry, idx, event))

    def _unsafe_post(self, event: Event) -> None:
        h = self.horizons
        bound = (self.window_end if h is None
                 else h[event.component.cluster_id])
        raise RuntimeError(
            f"lookahead safety violation: {event!r} targets another "
            f"cluster before its safe horizon {bound}; route "
            "cross-component traffic through a Connection with latency "
            ">= the engine's lookahead window (and with the edge "
            "declared in cluster_edges under bounded lag)")

    def execute(self) -> "_GroupCtx":
        """Drain the round: a two-stream merge of the adopted slice
        (iterated by index -- it is already sorted) against the
        side heap of events handlers push back into the window.  The
        stream pick compares raw entry tuples; local seqs live above
        ``LOCAL_SEQ_BASE`` so the comparison never reaches the event.

        Event dispatch is inlined (the body of ``Engine._handle_one``)
        with the thread-local clock and sink managed once per round
        instead of once per event -- with ~2-3 events per cluster per
        round, the per-activation wrappers would otherwise rival the
        handlers themselves.
        """
        eng = self.sched.engine
        tls = eng._tls
        prev_sink = getattr(tls, "sink", None)
        prev_now = getattr(tls, "now", None)
        tls.sink = self.post
        hooked = eng._handle_hooked
        adopted = self._adopted
        n_adopted = len(adopted)
        side = self.local._heap
        pop = _heappop
        entry = None
        i = 0
        n = 0
        try:
            while True:
                if side:
                    if i < n_adopted and adopted[i] < side[0]:
                        entry = adopted[i]
                        i += 1
                    else:
                        entry = pop(side)
                elif i < n_adopted:
                    entry = adopted[i]
                    i += 1
                else:
                    break
                self._entry = entry
                ev = entry[4]
                comp = ev.component
                tls.now = entry[0]
                # eng.hooks_active is re-read per event (not hoisted):
                # a handler may attach an engine hook mid-round, and
                # serial would observe the remaining events with it
                if eng.hooks_active or comp.hooks_active:
                    hooked(ev, comp)
                elif not comp.fault_failed:
                    if ev.kind != "notify_available":
                        comp.handle(ev)
                    else:
                        comp.notify_available(ev.payload)
                elif ev.kind == "notify_available":
                    ev.payload.reclaim(comp)
                n += 1
        finally:
            self.executed = n
            if n:
                self.max_time = entry[0]    # merge order => the maximum
            tls.sink = prev_sink
            tls.now = prev_now
        return self


class RoundScheduler(Scheduler):
    """Round-based scheduler: pop a window per shard, run groups, commit.

    Grouping is always by engine cluster (``compute_clusters``; the
    event queue is sharded the same way), so a cluster's window slice
    pops straight out of its own shard.  Subclasses choose the window
    width (:meth:`window_end`); ``use_pool`` turns on parallel worker
    dispatch.  *Where* a grouped round's contexts execute is delegated
    to a pluggable executor backend (``executor_spec``, default
    ``"threads"``; see :mod:`repro.core.engine.executor`) -- this class
    only selects the execution *mode* per round (merged serial-
    equivalent vs grouped) and runs the commit.  The commit phase
    pushes newly created events per destination shard in serial post
    order (stamp order), so all same-(time, rank) tie-breaks -- the
    only place seq is ever consulted -- are identical to serial
    execution, whichever executor ran the round.
    """

    use_pool = False
    strict_window = False
    record_window_widths = False
    # Bounded-lag mode: drop the global round barrier and give every
    # cluster its own conservative horizon derived from the cluster
    # graph (``Engine.cluster_graph``).  ``run`` then dispatches to
    # :meth:`_run_bounded` -- per-cluster windows, stamp-staged commit
    # with seq assignment deferred to each shard's flush.
    bounded_lag = False
    # Executor backend (name or instance) resolved in ``prepare``.  The
    # "threads" default keeps state in-process, which is what allows
    # the adaptive merged/degenerate inline paths below; backends with
    # shard-resident state (``"procs"``) declare ``inline_rounds =
    # False`` and receive every round, however narrow.
    executor_spec = "threads"
    executor = None                         # bound instance, set by prepare
    # Record per-round (cluster id, events) pairs into
    # ``engine.round_group_sizes`` -- the input to the architectural
    # (critical-path) speedup model benchmarks report.  Off by default:
    # long runs would accumulate one tuple per round.
    record_group_sizes = False
    # One-tick windows must defer even same-group posts to the commit
    # phase: a same-time post from a *lower-rank* group (e.g. a
    # zero-latency connection's request) would otherwise be committed
    # while the target group already ran its own same-time self-posts
    # locally -- inverting serial's seq order between the two.  Windowed
    # schedulers instead fuse zero-latency connections into the target's
    # cluster, which keeps in-window local execution serial-ordered.
    defer_all_posts = True
    # Rounds smaller than this run inline on the scheduler thread: pool
    # dispatch costs a fixed ~100us per round, so scattering a dozen
    # events across workers is pure overhead (and under CPython's GIL,
    # pure-Python handlers gain nothing physical from the pool anyway).
    # The pool engages only when a round is wide enough to amortize the
    # dispatch -- the regime where GIL-releasing handlers /
    # free-threaded builds actually scale.
    pool_min_events = 256

    def window_end(self, t: int):
        return t + 1                        # one integer-ps tick

    def group_of(self, component) -> int:
        """The sequential-execution group (== queue shard) of a
        component.  Always its engine cluster."""
        return component.cluster_id

    def prepare(self) -> None:
        """Called once per ``run``: derive clusters, shard the queue,
        build the persistent per-cluster contexts and bring up the
        executor backend."""
        eng = self.engine
        self._cluster_of = eng.compute_clusters()
        nshards = max(1, (max(self._cluster_of) + 1) if self._cluster_of
                      else 1)
        eng.queue = ShardedEventQueue.from_queue(eng.queue, nshards)
        self._ctxs = [_GroupCtx(self, gid) for gid in range(nshards)]
        self._merged = _MergedCtx(self, -1)
        self._merged.push_global = eng.queue.push
        self._commit: list = []             # reused per-round post buffer
        if self.bounded_lag:
            self._lag_graph = eng.cluster_graph()
            self._staged = [[] for _ in range(nshards)]
            self._horizons = [0] * nshards
        self.executor = make_executor(self.executor_spec,
                                      max_workers=self.max_workers)
        self.executor.bind(self)
        self.executor.prepare(self._ctxs)

    def run(self, until_ps: int = None) -> int:
        if self.bounded_lag:
            return self._run_bounded(until_ps)
        eng = self.engine
        self.prepare()
        queue = eng.queue
        ctxs = self._ctxs
        commit = self._commit
        executor = self.executor
        # Only executors whose state lives in this process may let the
        # scheduler thread execute events itself (the merged/degenerate
        # serial-equivalent paths); shard-resident backends must see
        # every round, however narrow.
        inline_ok = executor.inline_rounds
        pool_min = self.pool_min_events
        record_widths = self.record_window_widths
        record_groups = self.record_group_sizes
        tls = eng._tls
        serial_sink = guarded_push(eng, queue)
        # Execution-mode predictor: rounds narrower than pool_min_events
        # run serial-equivalent (merged / degenerate), wider rounds run
        # grouped on the executor.  The mode must be chosen before the
        # pop, so the previous round's width predicts the next -- safe
        # because BOTH modes are bit-exact; a mispredict only costs
        # speed, and the predictor corrects itself on the very next
        # round.
        prefer_merged = inline_ok and pool_min > 1 and not record_groups
        failed = True
        try:
            while queue:
                t = queue.peek_time()
                if until_ps is not None and t > until_ps:
                    break
                eng.now = t
                wend = self.window_end(t)
                if until_ps is not None:
                    wend = min(wend, until_ps + 1)

                if prefer_merged:
                    merged = queue.pop_window_merged(wend)
                    nev = len(merged)
                    prefer_merged = nev < pool_min
                    if nev == 1:
                        # Degenerate: the sink pushes posts straight onto
                        # the (sharded) global queue in post order --
                        # exactly serial semantics.
                        ev = merged[0][4]
                        prev_sink = getattr(tls, "sink", None)
                        tls.sink = serial_sink
                        try:
                            eng._handle_one(ev)
                        finally:
                            tls.sink = prev_sink
                        eng.events_processed += 1
                        eng.batch_widths.append(1)
                        if record_widths:
                            eng.window_widths.append(1)
                        eng.now = ev.time
                        continue
                    # Merged round: ONE group spanning every cluster --
                    # the machinery's base case, serial-equivalent by
                    # construction (see _MergedCtx); beyond-window posts
                    # push themselves straight onto the sharded queue.
                    ctx = self._merged
                    ctx.begin(wend, merged)
                    ctx.execute()
                    eng.events_processed += ctx.executed
                    eng.batch_widths.append(ctx.executed)
                    if record_widths:
                        eng.window_widths.append(ctx.executed)
                    eng.now = ctx.max_time if ctx.max_time > t else t
                    continue

                popped, nev = queue.pop_window_sharded(wend)
                prefer_merged = (inline_ok and nev < pool_min
                                 and not record_groups)

                tasks = []
                for sid, entries in popped:
                    ctx = ctxs[sid]
                    ctx.begin(wend, entries)
                    tasks.append(ctx)

                executor.run_round(tasks, nev)

                executed = 0
                tmax = t
                for ctx in tasks:
                    executed += ctx.executed
                    if ctx.max_time > tmax:
                        tmax = ctx.max_time
                eng.events_processed += executed
                eng.batch_widths.append(executed)
                if record_widths:
                    eng.window_widths.append(executed)
                if record_groups:
                    eng.round_group_sizes.append(
                        tuple((ctx.group_id, ctx.executed)
                              for ctx in tasks))

                # Commit: push this round's posts in serial post (stamp)
                # order.  Each context's log is already stamp-sorted (its
                # execution is sequential), so the combined commit is
                # C-level bulk work: extend the runs together, one
                # near-linear Timsort merge, then push -- ``queue.push``
                # routes each event to its cluster's shard, where the
                # stamp order becomes the same-(time, rank) seq order
                # serial would have produced.  With a single contributing
                # context the sort is skipped outright.
                sources = 0
                for ctx in tasks:
                    if ctx.posts:
                        sources += 1
                        commit.extend(ctx.posts)
                        ctx.posts.clear()
                if commit:
                    if sources > 1:
                        # (entry, idx, event) triples sort by entry then
                        # idx -- the serial post order; seq uniqueness
                        # means the comparison never reaches the event
                        commit.sort()
                    push = queue.push
                    for p in commit:
                        push(p[2])
                    commit.clear()
                eng.now = tmax
            failed = False
        finally:
            executor.finalize(failed=failed)
        return eng.now

    # -- bounded lag ----------------------------------------------------------
    def _compute_horizons(self, lvt: list) -> list:
        """Per-cluster safe execution horizons for one wave.

        ``lvt[i]`` is cluster i's earliest pending event time (shard
        head or staged in-flight post; ``inf`` when idle).  The classic
        conservative earliest-input-time relaxation runs a multi-source
        shortest path over the cluster graph::

            eit[i] = min(lvt[i], min over in-edges j->i of eit[j] + L)

        which bounds, transitively through idle clusters, the earliest
        time *any* chain of future events could make cluster i execute.
        Cluster i may then safely run every event strictly below::

            H[i] = min over in-edges j->i of (eit[j] + L[j->i])

        because an event posted by cluster j executing at ``tau >=
        eit[j]`` arrives at ``tau + L >= H[i]`` -- nothing can appear
        inside the window being executed.  The globally earliest
        cluster always gets ``H > lvt`` (inter-cluster latencies are
        >= 1), so every wave makes progress; clusters with no in-edges
        are unbounded.

        The relaxation runs over the *node-level* graph: beyond the
        per-cluster default nodes (base = lvt), connections may have
        declared predicate-refined nodes whose base is the earliest
        pending event *matching the predicate* -- a link's in-flight
        serialization vs. its still-queued transfer requests, the
        controller's non-completion inputs.  Pred bases come from one
        read-only scan of the owning shard's heap plus its staged
        posts, done only for clusters that declared refinements.
        """
        g = self._lag_graph
        ncl = g.n_clusters
        eit = list(lvt)
        if g.n_nodes > ncl:
            eit.extend(_INF for _ in range(ncl, g.n_nodes))
            for ix, cid in g.plain_nodes:   # pred-less waypoints
                eit[ix] = lvt[cid]
            shards = self.engine.queue._shards  # read-only heap scan
            staged = self._staged
            for cid, members in g.pred_scans:
                for e in shards[cid]:
                    t, ev = e[0], e[4]
                    for ix, pred in members:
                        if t < eit[ix] and pred(ev):
                            eit[ix] = t
                for p in staged[cid]:
                    ev = p[2]
                    t = ev.time
                    for ix, pred in members:
                        if t < eit[ix] and pred(ev):
                            eit[ix] = t
        out_edges = g.out
        heap = [(t, i) for i, t in enumerate(eit) if t != _INF]
        _heapify(heap)
        while heap:
            d, i = _heappop(heap)
            if d > eit[i]:
                continue
            for j, lat in out_edges[i]:
                nd = d + lat
                if nd < eit[j]:
                    eit[j] = nd
                    _heappush(heap, (nd, j))
        horizons = self._horizons
        for i, edges in enumerate(g.horizon_in):
            h = _INF
            for j, lat in edges:
                b = eit[j] + lat
                if b < h:
                    h = b
            horizons[i] = h
        return horizons

    def _run_bounded(self, until_ps: int = None) -> int:
        """Bounded-lag drain: per-cluster windows, no global barrier.

        Each wave computes every cluster's horizon, then runs *all*
        clusters with work below their horizon concurrently -- a
        decoupled cluster may advance far beyond the global floor while
        a laggard catches up, synchronizing only with the clusters it
        actually exchanges events with.

        Bit-identity is preserved by deferring seq assignment: a wave's
        beyond-window / cross-cluster posts are *staged* per destination
        shard still carrying only their serial post-order stamps, and a
        shard's staged posts are flushed (stamp-sorted, seqs assigned,
        pushed) only once the shard's horizon passes their arrival time
        -- at which point conservatism guarantees every same-(time,
        rank) competitor has already been staged, so per-shard seq order
        equals serial's.  Cross-shard seq skew is unobservable (the
        seq-locality argument on ``ShardedEventQueue``).

        The merged / degenerate inline paths are structurally disabled:
        they assign seqs at post time, which is only serial-equivalent
        when all clusters share one floor.  Narrow waves instead run
        grouped-inline on the executor (the thread backend executes
        small rounds on the scheduler thread anyway).
        """
        eng = self.engine
        self.prepare()
        queue = eng.queue
        ctxs = self._ctxs
        staged = self._staged
        executor = self.executor
        record_widths = self.record_window_widths
        record_groups = self.record_group_sizes
        nsh = len(ctxs)
        shard_head = queue.shard_head_time
        pop_shard = queue.pop_shard_window
        push = queue.push
        lvt = [0] * nsh
        now_max = eng._now_global
        failed = True
        try:
            while True:
                floor = _INF
                for sid in range(nsh):
                    t = shard_head(sid)
                    t = _INF if t is None else t
                    for p in staged[sid]:
                        pt = p[2].time
                        if pt < t:
                            t = pt
                    lvt[sid] = t
                    if t < floor:
                        floor = t
                if floor == _INF:
                    break
                if until_ps is not None and floor > until_ps:
                    break
                eng.now = floor
                horizons = self._compute_horizons(lvt)
                if until_ps is not None:
                    cap = until_ps + 1
                    for i in range(nsh):
                        if horizons[i] > cap:
                            horizons[i] = cap

                tasks = []
                nev = 0
                for sid in range(nsh):
                    hzn = horizons[sid]
                    s = staged[sid]
                    if s:
                        due = [p for p in s if p[2].time < hzn]
                        if due:
                            if len(due) == len(s):
                                s.clear()
                            else:
                                s[:] = [p for p in s if p[2].time >= hzn]
                            due.sort()  # stamp order == serial seq order
                            for p in due:
                                push(p[2])
                    entries = pop_shard(sid, hzn)
                    if entries:
                        ctx = ctxs[sid]
                        ctx.begin(hzn, entries)
                        ctx.horizons = horizons
                        tasks.append(ctx)
                        nev += len(entries)
                assert tasks, "bounded-lag wave made no progress"

                executor.run_round(tasks, nev)

                executed = 0
                tmax = floor
                for ctx in tasks:
                    executed += ctx.executed
                    if ctx.max_time > tmax:
                        tmax = ctx.max_time
                eng.events_processed += executed
                eng.batch_widths.append(executed)
                if record_widths:
                    eng.window_widths.append(executed)
                if record_groups:
                    eng.round_group_sizes.append(
                        tuple((ctx.group_id, ctx.executed)
                              for ctx in tasks))

                # Stage (don't push) this wave's posts per destination
                # shard; the flush above assigns seqs when it is safe.
                for ctx in tasks:
                    posts = ctx.posts
                    if posts:
                        for p in posts:
                            staged[p[2].component.cluster_id].append(p)
                        posts.clear()
                if tmax > now_max:
                    now_max = tmax
            failed = False
        finally:
            # Return undelivered staged posts to the queue so pending
            # state is all queue-resident (partial runs resume; the
            # procs backend materializes payload refs off the queue).
            # Safe: at exit nothing executed past ``until_ps`` and
            # every future stamp exceeds the ones flushed here.
            rem = []
            for s in staged:
                rem.extend(s)
                s.clear()
            if rem:
                rem.sort()
                for p in rem:
                    push(p[2])
            executor.finalize(failed=failed)
        eng.now = now_max
        return now_max

    def describe(self) -> dict:
        d = super().describe()
        d["executor"] = (self.executor.describe() if self.executor
                         is not None else self.executor_spec)
        d["bounded_lag"] = self.bounded_lag
        return d


class _MergedCtx(_GroupCtx):
    """Whole-window context for rounds too narrow to pay for grouping.

    One group containing *every* cluster is the base case of the round
    machinery: all in-window posts are same-group, so the LocalQueue's
    generation bookkeeping reproduces serial's snapshot rounds exactly
    and no cross-group commit-order hazard exists -- execution is
    serial-equivalent by construction.  Because a single group's
    execution order *is* the serial post order, beyond-window posts
    skip the commit log entirely and push straight onto the sharded
    queue -- seq assignment at post time equals what a stamp-ordered
    commit would produce.  The unsafe-post guard is structural here:
    with nothing running concurrently there is no determinism to
    corrupt (set ``pool_min_events = 0`` to force grouped execution
    when the diagnostic guard itself is wanted).
    """

    __slots__ = ("push_global",)

    def __init__(self, sched: "RoundScheduler", group_id: int) -> None:
        super().__init__(sched, group_id)
        self.push_global = None             # bound queue.push, set by prepare

    def post(self, event: Event) -> None:
        e = self._entry
        assert event.time >= e[0], "cannot schedule into the past"
        if event.time < self.window_end:
            self.local.push_new(
                event, generation=e[1] + 1 if event.time == e[0] else 0)
        else:
            self.push_global(event)


