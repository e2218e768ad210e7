"""Event system (paper Sec. 4.1, part 1).

An :class:`Event` marks an update of system state at a particular time.
The engine keeps a priority queue of events ordered by
``(time, component_rank, seq)``:

* ``time``            -- integer picoseconds (exact ordering, no float ties)
* ``component_rank``  -- stable per-component rank, so same-timestamp events
                         group deterministically by component (this grouping
                         is the unit of conservative parallelism, DP-5)
* ``seq``             -- global monotonically increasing schedule order

Events carry an opaque ``kind`` + ``payload``; the owning component's
``handle`` interprets them.  A component can only schedule events for
itself (enforced in :meth:`Component.schedule`), mirroring MGSim's rule
that "a component can only schedule events to itself".

Two queue implementations share one entry layout ``(time, generation,
rank, seq, event)`` (generation is 0 for every globally queued event --
it only orders same-timestamp chains inside a :class:`LocalQueue`):

* :class:`EventQueue` -- a single min-heap; what the serial scheduler
  drains and what every engine starts with.
* :class:`ShardedEventQueue` -- one heap *per scheduler cluster*,
  fronted by a small lazily-validated heap of shard head times.  Round
  schedulers swap the engine's queue to this in ``prepare()``: a round's
  window pops straight out of each shard in shard order, already
  partitioned by execution group and already sorted, so no event ever
  funnels through a global heap.  The total order is preserved
  bit-exactly because ``seq`` -- the only cross-shard-unsafe key -- is
  never compared across shards: it tie-breaks same-``(time, rank)``
  entries only, and a rank (a component) lives in exactly one shard.
"""
from __future__ import annotations

import heapq
import itertools
import typing


class EmptyQueueError(IndexError):
    """Raised by ``peek_time`` on an empty queue.

    Subclasses :class:`IndexError` so callers that guarded against the
    old bare ``heap[0]`` failure keep working, but carries an actual
    explanation instead of ``list index out of range``.
    """


class Event:
    """A scheduled state update.  Plain ``__slots__`` class on the hot
    path: the queue stamps ``seq`` in place when the event is pushed
    (exactly once -- events are single-use), so scheduling an event
    allocates one object and zero copies."""

    __slots__ = ("time", "component", "kind", "payload", "seq")

    def __init__(self, time: int, component: "typing.Any", kind: str,
                 payload: typing.Any = None, seq: int = -1) -> None:
        self.time = time               # picoseconds
        self.component = component     # the Component that will handle this
        self.kind = kind
        self.payload = payload
        self.seq = seq                 # stamped by the queue on push

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Event(t={self.time}ps, "
                f"{getattr(self.component, 'name', '?')}, {self.kind})")


class EventQueue:
    """Min-heap of events keyed (time, component_rank, seq)."""

    def __init__(self) -> None:
        self._heap: list = []
        self._counter = itertools.count()

    def push(self, event: Event) -> Event:
        event.seq = seq = next(self._counter)
        comp = event.component
        heapq.heappush(self._heap, (event.time, 0, comp.rank, seq, event))
        return event

    def pop(self) -> Event:
        return heapq.heappop(self._heap)[4]

    def peek_time(self) -> int:
        if not self._heap:
            raise EmptyQueueError("peek_time on an empty event queue")
        return self._heap[0][0]

    def pop_batch(self) -> list:
        """Pop *all* events sharing the earliest timestamp.

        Those events are, by construction of the component system,
        mutually independent across components: a handler may only touch
        its own component's state.  This is the conservative-parallel
        batch of DP-5.
        """
        if not self._heap:
            return []
        return self.pop_window(self._heap[0][0] + 1)

    def pop_window(self, end_time) -> list:
        """Pop every event with ``time < end_time`` in (time, rank, seq)
        order — the unit of work of a lookahead window (conservative
        PDES: the caller guarantees no event created inside the window
        can target another component before ``end_time``)."""
        heap = self._heap
        out = []
        while heap and heap[0][0] < end_time:
            out.append(heapq.heappop(heap)[4])
        return out

    def _take_entries(self) -> list:
        """Drain the raw (time, gen, rank, seq, event) entries (queue
        migration; see :meth:`ShardedEventQueue.from_queue`)."""
        heap, self._heap = self._heap, []
        return heap

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class ShardedEventQueue:
    """Per-cluster shard heaps fronted by a small heap of shard heads.

    ``push`` routes an event to the shard of its component's
    ``cluster_id``; a round scheduler's window pop
    (:meth:`pop_window_sharded`) drains each shard whose head falls
    inside the window and hands the per-shard entry lists straight to
    that cluster's execution context -- no global merge, no re-sort, no
    per-event re-wrapping (the entries double as the local working
    heap, because an ascending list is a valid min-heap).

    **Why this preserves the serial total order bit-exactly.**  The
    global order is ``(time, rank, seq)``.  ``time`` and ``rank`` are
    intrinsic to the event; only ``seq`` is assigned by the queue.  But
    ``seq`` is reached only when ``(time, rank)`` ties -- i.e. between
    two events for the *same component*, which by construction live in
    the *same shard*.  So as long as each shard receives its events in
    serial post order (the commit phase sorts per shard by post stamp),
    cross-shard seq skew is unobservable: any comparison between events
    of different shards is already decided by ``(time, rank)``.

    The head heap is lazy: ``push`` records a shard's head time only
    when it improves, and stale entries are discarded on the next
    ``peek_time``/pop when they no longer match their shard's actual
    head.  Every non-empty shard always has at least one live entry.
    """

    def __init__(self, num_shards: int, counter=None) -> None:
        self.num_shards = num_shards
        self._shards: list = [[] for _ in range(num_shards)]
        self._heads: list = []          # (head_time, shard_id), lazy
        self._counter = counter if counter is not None else itertools.count()
        self._len = 0

    @classmethod
    def from_queue(cls, queue, num_shards: int) -> "ShardedEventQueue":
        """Re-home a queue's pending events into per-cluster shards.

        Accepts a plain :class:`EventQueue` or an already-sharded queue
        (clusters may change between runs); existing seqs and the live
        counter carry over, so pending events keep their serial order.
        """
        q = cls(num_shards, counter=queue._counter)
        shards = q._shards
        n = 0
        for entry in queue._take_entries():
            shards[entry[4].component.cluster_id].append(entry)
            n += 1
        for sid, shard in enumerate(shards):
            if shard:
                heapq.heapify(shard)
                heapq.heappush(q._heads, (shard[0][0], sid))
        q._len = n
        return q

    def push(self, event: Event) -> Event:
        event.seq = seq = next(self._counter)
        comp = event.component
        shard = self._shards[comp.cluster_id]
        time = event.time
        if not shard or time < shard[0][0]:
            heapq.heappush(self._heads, (time, comp.cluster_id))
        heapq.heappush(shard, (time, 0, comp.rank, seq, event))
        self._len += 1
        return event

    def peek_time(self) -> int:
        heads, shards = self._heads, self._shards
        while heads:
            t, sid = heads[0]
            shard = shards[sid]
            if shard and shard[0][0] == t:
                return t
            heapq.heappop(heads)        # stale: head popped or shard drained
        raise EmptyQueueError("peek_time on an empty event queue")

    def shard_head_time(self, sid: int):
        """Earliest pending time in one shard (``None`` when empty).
        Bounded-lag schedulers read every shard's head to compute
        per-cluster lower bounds, bypassing the global head heap."""
        shard = self._shards[sid]
        return shard[0][0] if shard else None

    def pop_shard_window(self, sid: int, end_time) -> list:
        """Pop one shard's events with ``time < end_time`` in
        (time, rank, seq) order -- the bounded-lag feed, where every
        cluster gets its *own* window end instead of a shared one.
        Stale head-heap entries for the shard self-clean on the next
        ``peek_time``; only a (possibly) improved head is re-pushed."""
        shard = self._shards[sid]
        batch = []
        while shard and shard[0][0] < end_time:
            batch.append(heapq.heappop(shard))
        if batch:
            self._len -= len(batch)
            if shard:
                heapq.heappush(self._heads, (shard[0][0], sid))
        return batch

    def pop_window_sharded(self, end_time) -> tuple:
        """Pop every event with ``time < end_time``; returns
        ``([(shard_id, entries), ...], total_events)`` with shards in
        ascending id order and each entries list ascending in
        (time, rank, seq) -- the exact feed a round scheduler's
        per-cluster contexts adopt."""
        heads, shards = self._heads, self._shards
        out = []
        nev = 0
        while heads:
            t, sid = heads[0]
            shard = shards[sid]
            if not shard or shard[0][0] != t:
                heapq.heappop(heads)
                continue
            if t >= end_time:
                break
            batch = []
            while shard and shard[0][0] < end_time:
                batch.append(heapq.heappop(shard))
            nev += len(batch)
            out.append((sid, batch))
            heapq.heappop(heads)
            if shard:
                heapq.heappush(heads, (shard[0][0], sid))
        self._len -= nev
        out.sort()                          # shard ids are unique -> no
        return out, nev                     # tie ever compares the lists

    def pop_window_merged(self, end_time) -> list:
        """Pop every event with ``time < end_time`` into one list,
        sorted in global (time, rank, seq) order -- the feed of a
        merged (serial-equivalent) round.  One allocation, one
        near-linear sort over the per-shard sorted runs."""
        heads, shards = self._heads, self._shards
        out = []
        while heads:
            t, sid = heads[0]
            shard = shards[sid]
            if not shard or shard[0][0] != t:
                heapq.heappop(heads)
                continue
            if t >= end_time:
                break
            while shard and shard[0][0] < end_time:
                out.append(heapq.heappop(shard))
            heapq.heappop(heads)
            if shard:
                heapq.heappush(heads, (shard[0][0], sid))
        self._len -= len(out)
        out.sort()                          # seqs unique -> never compares
        return out                          # the entries' event field

    def pop_window(self, end_time) -> list:
        """Globally (time, rank, seq)-ordered window pop (compatibility
        path; round schedulers use the sharded/merged variants)."""
        return [e[4] for e in self.pop_window_merged(end_time)]

    def pop_batch(self) -> list:
        if not self._len:
            return []
        return self.pop_window(self.peek_time() + 1)

    def pop(self) -> Event:
        t = self.peek_time()            # validates the head heap
        # The head heap orders shards by time only, so a cross-shard
        # time tie must be broken by the actual head entries (rank is
        # the global tie-break and ranks are unique across shards).
        best_sid = -1
        best = None
        for sid, shard in enumerate(self._shards):
            if shard and shard[0][0] == t and (best is None
                                               or shard[0] < best):
                best = shard[0]
                best_sid = sid
        shard = self._shards[best_sid]
        heapq.heappop(shard)
        self._len -= 1
        if shard:                       # stale head entries self-clean
            heapq.heappush(self._heads, (shard[0][0], best_sid))
        return best[4]

    def _take_entries(self) -> list:
        out = []
        for shard in self._shards:
            out.extend(shard)
            shard.clear()
        self._heads.clear()
        self._len = 0
        return out

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0


class LocalQueue:
    """Per-group working heap used inside one scheduler round.

    Holds the group's slice of a popped window plus any events its own
    handlers schedule back into the window.  Keys are (time, generation,
    rank, seq):

    * ``generation`` reproduces the serial engine's snapshot-round
      semantics for same-timestamp chains: serial pops *all* events at
      time t, runs them in (rank, seq) order, and any delay-0 posts they
      make wait for the next same-t round.  A locally created event at
      its creator's own timestamp therefore carries ``creator's
      generation + 1`` so it sorts after every same-t event of the
      current round regardless of rank; events created for a later
      timestamp reset to generation 0 (serial would see them in that
      timestamp's first snapshot).
    * locally created events draw seqs from a high base so they sort
      *after* every globally assigned seq at the same (time, gen, rank)
      — exactly where serial's monotonically increasing post-time seqs
      would put them.  The disjoint seq ranges also let a group context
      merge this heap against its adopted (globally-stamped) shard
      slice by raw entry comparison.

    The queue is long-lived (one per scheduler cluster) and, in the
    round machinery, holds only the events handlers push back *into*
    the current window -- the popped window itself is iterated in place
    by the group context, so the common no-local-post round never
    re-heaps anything.
    """

    LOCAL_SEQ_BASE = 1 << 60

    __slots__ = ("_heap", "_counter")

    def __init__(self) -> None:
        self._heap: list = []
        self._counter = itertools.count(self.LOCAL_SEQ_BASE)

    def clear(self) -> None:
        self._heap.clear()

    def adopt(self, event: Event) -> None:
        """Add an event already carrying a globally assigned seq."""
        heapq.heappush(self._heap,
                       (event.time, 0, event.component.rank, event.seq, event))

    def push_new(self, event: Event, generation: int = 0) -> Event:
        """Add an event created during this round; assigns a local seq."""
        event.seq = seq = next(self._counter)
        heapq.heappush(self._heap,
                       (event.time, generation, event.component.rank, seq,
                        event))
        return event

    def pop(self) -> tuple:
        """Returns (generation, event) in (time, gen, rank, seq) order."""
        entry = heapq.heappop(self._heap)
        return entry[1], entry[4]

    def peek_time(self) -> int:
        if not self._heap:
            raise EmptyQueueError("peek_time on an empty local queue")
        return self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
