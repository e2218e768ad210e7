"""Process-backed executor: shard-resident state on real cores.

The GIL makes ``threads`` a correctness backend, not a speed one, for
pure-Python handlers.  ``procs`` converts the schedulers' architectural
parallelism into wall-clock the way partitioned simulators do (ACALSim;
Huerta 2025): partition state, keep it partitioned, exchange messages.

**Topology.**  ``prepare`` forks one long-lived worker process per
bucket (``processes = min(max_workers, os.cpu_count())`` -- more
workers than cores just adds scheduling noise) *after*
``compute_clusters``, so every worker starts with a bit-identical
replica of the fully wired component graph.  A cluster is pinned to
worker ``cluster_id % processes`` for the whole run -- the same sticky
assignment the thread pool uses -- and from then on that worker's
replica of the cluster's components is the *authoritative* one: the
parent's copies go stale until the end-of-run state sync.

**Per round** (plain-pickled envelopes of ints/strings/bytes; carried
over shared-memory rings when :mod:`rings` is available, else over the
worker's duplex pipe -- same frames either way):

* parent -> worker: the window's event entries for each of the worker's
  clusters -- ``(sid, window_end, (time, rank, seq, kind, payload-ref)
  tuples)`` groups, plus the wave's shared per-cluster ``horizons``
  list (``None`` under a global-barrier scheduler).  Per-group window
  ends are what lets the bounded-lag scheduler run clusters at
  *different* horizons within one exchange.
* worker: runs the ordinary ``_GroupCtx`` machinery (local side-heap,
  generation bookkeeping, strict-window guard) over its clusters;
  handlers mutate shard-resident state with no locks and no GIL
  contention.
* worker -> parent: per cluster ``(executed, max_time, posts)`` where
  posts are ``(commit stamp, intra-handler idx, event coordinates)`` --
  beyond-window posts and cross-cluster sends only; in-window local
  events never leave the worker.
* parent: rebuilds the posts as events and runs the unchanged commit --
  stamp-sort, push per destination shard -- so seq assignment, and
  therefore the simulation, stays bit-identical to serial.

**Payloads stay shard-resident too.**  Event payloads (requests,
routing stubs) reference live simulation objects, so shipping them is
the protocol's only nontrivial serialization -- and it is mostly
avoided:

* a post whose destination cluster lives in the *same* worker parks its
  payload in that worker's payload cache and sends only the cache key
  (``("L", key)``) -- zero pickling for the dominant
  own-cluster-beyond-window traffic;
* posts to *other* workers batch their payloads into one
  :mod:`wire`-encoded blob per destination worker per round
  (references encode as ranks, so the blob decodes against any
  replica); the parent routes the blob to its destination unopened,
  piggybacked on the next round message, and entries reference items as
  ``("B", src worker, blob seq, index)``;
* the few parent-born payloads (initial trace events) ship
  individually as ``("P", bytes)``.

**End of run.**  Each worker ships ``shard_state()`` for the components
it owns (references encoded as ranks, so parent-graph identity is
preserved) plus any engine-level hooks that declare ``merge_shard``;
the parent applies both.  Hooks without ``merge_shard`` (e.g. Tracer)
keep only parent-side observations -- see docs/engine.md for the exact
residency rules.

A worker that dies mid-run surfaces as a ``RuntimeError`` naming the
worker, never a hang: on the pipe transport each child closes every
pipe end it does not own, so the parent sees EOF the moment the
process exits; on the ring transport every blocking ring operation
runs a liveness ``deadcheck`` (the parent polls the worker process,
the worker polls its parent pid) once it leaves the hot spin.
Worker-side exceptions (including the lookahead strict-window guard)
travel back with their traceback and re-raise in the parent.
"""
from __future__ import annotations

import multiprocessing
import os
import traceback

from . import rings, wire
from .base import Executor, register_executor
from ...event import Event

_plain_dumps = wire.plain_dumps
_plain_loads = wire.plain_loads


class _Ref:
    """Parent-side stand-in for a payload that lives in a worker: the
    parent routes the reference, never the object."""

    __slots__ = ("ref",)

    def __init__(self, ref) -> None:
        self.ref = ref

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"_Ref({self.ref!r})"


class _WorkerState:
    """Shard-worker side of the protocol (lives in the forked child)."""

    def __init__(self, sched, wid: int, nprocs: int, send) -> None:
        from ..base import _GroupCtx      # late: avoid import cycle
        self._GroupCtx = _GroupCtx
        self.sched = sched
        self.eng = sched.engine
        self.wid = wid
        self.nprocs = nprocs
        self.send = send                  # reply-bytes sink (ring or pipe)
        self.ctxs: dict = {}              # cluster id -> _GroupCtx (lazy)
        self.local: dict = {}             # key -> parked own-cluster payload
        self.local_seq = 0
        self.blob_seq = 0
        self.blobs: dict = {}             # (src wid, seq) -> [payloads, n]
        # Mergeable hooks accumulate into fresh replicas: the fork
        # carried the parent's pre-run state, and merging that baseline
        # back would double-count it once per worker.  Engine-level
        # hooks fire in every worker; component/connection-level hooks
        # fire only in the item's owning worker (a hooked connection is
        # stateful_send, hence fused with its endpoints), so swapping
        # the owned items' lists covers every firing exactly once.
        hooks = self.eng._hooks
        self.merge_idx = [i for i, h in enumerate(hooks)
                          if hasattr(h, "merge_shard")]
        for i in self.merge_idx:
            hooks[i] = hooks[i].fresh_shard()
        self.comp_merge: list = []        # (rank, hook index) pairs
        for comp in self.eng._components:
            if comp.cluster_id % nprocs != wid or not comp.hooks_active:
                continue
            comp_hooks = comp._hooks
            for i, h in enumerate(comp_hooks):
                if hasattr(h, "merge_shard"):
                    comp_hooks[i] = h.fresh_shard()
                    self.comp_merge.append((comp.rank, i))

    # -- payload refs ------------------------------------------------------
    def _resolve(self, pref):
        if pref is None:
            return None
        tag = pref[0]
        if tag == "L":                    # parked in this worker earlier
            return self.local.pop(pref[1])
        if tag == "B":                    # item of a routed blob
            slot = self.blobs[(pref[1], pref[2])]
            payload = slot[0][pref[3]]
            slot[1] -= 1
            if not slot[1]:
                del self.blobs[(pref[1], pref[2])]
            return payload
        return wire.loads(pref[1], self.eng)          # "P": parent-born

    def _decode_entries(self, wire_entries) -> list:
        comps = self.eng._components
        resolve = self._resolve
        return [(t, 0, rank, seq,
                 Event(t, comps[rank], kind, resolve(pref), seq))
                for t, rank, seq, kind, pref in wire_entries]

    def _encode_posts(self, posts, cross: dict) -> list:
        """Posts -> wire tuples; payloads park locally or join the
        per-destination-worker blob batches in ``cross``."""
        wid = self.wid
        nprocs = self.nprocs
        out = []
        for entry, idx, ev in posts:
            comp = ev.component
            p = ev.payload
            if p is None:
                pref = None
            elif comp.cluster_id % nprocs == wid:
                key = self.local_seq = self.local_seq + 1
                self.local[key] = p
                pref = ("L", key)
            else:
                dst = comp.cluster_id % nprocs
                batch = cross.get(dst)
                if batch is None:
                    # Each destination's batch gets its own blob seq:
                    # (src wid, seq) must stay unique across *all*
                    # blobs, because the parent pools them under that
                    # key when materializing stranded references after
                    # a partial run.
                    seq = self.blob_seq = self.blob_seq + 1
                    batch = cross[dst] = (seq, [])
                pref = ("B", wid, batch[0], len(batch[1]))
                batch[1].append(p)
            out.append(((entry[0], entry[1], entry[2], entry[3]), idx,
                        (ev.time, comp.rank, ev.kind, pref)))
        return out

    # -- message handlers --------------------------------------------------
    def round(self, groups, blobs, horizons) -> None:
        for src_wid, seq, blob_bytes, count in blobs:
            self.blobs[(src_wid, seq)] = [wire.loads(blob_bytes, self.eng),
                                          count]
        out = []
        cross: dict = {}
        for sid, wend, wire_entries in groups:
            ctx = self.ctxs.get(sid)
            if ctx is None:
                ctx = self.ctxs[sid] = self._GroupCtx(self.sched, sid)
            ctx.begin(wend, self._decode_entries(wire_entries))
            ctx.horizons = horizons       # bounded lag: target-cluster guard
            ctx.execute()
            posts = self._encode_posts(ctx.posts, cross)
            ctx.posts.clear()
            out.append((sid, ctx.executed, ctx.max_time, posts))
        wired = [(dst, seq, wire.dumps(batch, self.eng), len(batch))
                 for dst, (seq, batch) in cross.items()]
        self.send(_plain_dumps(("D", out, wired)))

    def collect(self) -> None:
        state = {c.rank: c.shard_state() for c in self.eng._components
                 if c.cluster_id % self.nprocs == self.wid}
        hooks = [(i, self.eng._hooks[i]) for i in self.merge_idx]
        comp_hooks = [(rank, i, self.eng._components[rank]._hooks[i])
                      for rank, i in self.comp_merge]
        # Ship the unconsumed payload caches too: a partial run
        # (``until_ps``) leaves committed events in the *parent* queue
        # whose payloads still live here -- the parent materializes
        # those references so a later run (with fresh workers) finds
        # real objects, not dangling cache keys.
        stranded_blobs = {k: v[0] for k, v in self.blobs.items()}
        self.send(wire.dumps(
            ("S", state, hooks, comp_hooks, self.local, stranded_blobs),
            self.eng))


def _worker_main(sched, wid: int, nprocs: int, child_ends, parent_ends,
                 ring_pairs):
    """Shard worker loop (runs in the forked child)."""
    for p in parent_ends:
        p.close()
    for i, c in enumerate(child_ends):
        if i != wid:
            c.close()
    conn = child_ends[wid]
    ring = None
    if ring_pairs is not None:
        for i, pair in enumerate(ring_pairs):
            if i != wid:
                pair.close()
        ring = ring_pairs[wid]
        ppid = os.getppid()

        def _parent_gone() -> None:
            # An orphaned worker must not spin on a ring no one feeds;
            # the pipe transport gets this for free via EOF.
            if os.getppid() != ppid:
                os._exit(1)

        ring.req.deadcheck = ring.rsp.deadcheck = _parent_gone
        recv, send = ring.req.recv_bytes, ring.rsp.send_bytes
    else:
        recv, send = conn.recv_bytes, conn.send_bytes
    state = _WorkerState(sched, wid, nprocs, send)
    try:
        while True:
            try:
                msg = _plain_loads(recv())
            except EOFError:
                break
            op = msg[0]
            try:
                if op == "R":             # one round's window slices
                    state.round(msg[1], msg[2], msg[3])
                elif op == "C":           # end of run: ship shard state
                    state.collect()
                elif op == "Q":
                    break
            except BaseException:
                send(_plain_dumps(("E", traceback.format_exc())))
    except (BrokenPipeError, KeyboardInterrupt):
        pass
    finally:
        conn.close()
        os._exit(0)


class ProcExecutor(Executor):
    name = "procs"
    inline_rounds = False                 # state is shard-resident

    def __init__(self, max_workers: int = 4) -> None:
        super().__init__(max_workers)
        # Clamped again per run to the cluster count in prepare() --
        # an idle worker would still hold a full forked replica.
        self._max_procs = max(1, min(max_workers, os.cpu_count() or 1))
        self.processes = self._max_procs
        self._procs: list = []
        self._conns: list = []
        self._rings = None                # list[RingPair] when in use
        self.transport = "pipes"
        self._msgs: dict = {}             # reused per-round send buffer
        self._pending_blobs: dict = {}    # dst wid -> blobs awaiting routing

    # -- lifecycle --------------------------------------------------------
    def prepare(self, ctxs: list) -> None:
        if "fork" not in multiprocessing.get_all_start_methods():
            raise RuntimeError(
                "executor='procs' requires the fork start method (POSIX); "
                "use executor='threads' on this platform")
        mp = multiprocessing.get_context("fork")
        nprocs = self.processes = max(1, min(self._max_procs, len(ctxs)))
        pipes = [mp.Pipe(duplex=True) for _ in range(nprocs)]
        parent_ends = [p for p, _ in pipes]
        child_ends = [c for _, c in pipes]
        self._conns = parent_ends
        self._procs = []
        self._pending_blobs = {}
        # Round traffic rides shared-memory rings when the host has
        # them (created before the fork so children inherit the
        # mapping); the pipes stay open as the fallback transport and
        # for EOF-based death detection in either direction.
        self._rings = ([rings.RingPair() for _ in range(nprocs)]
                       if rings.available() else None)
        self.transport = "rings" if self._rings else "pipes"
        for wid in range(nprocs):
            proc = mp.Process(
                target=_worker_main,
                args=(self.scheduler, wid, nprocs, child_ends, parent_ends,
                      self._rings),
                daemon=True, name=f"shard-worker-{wid}")
            proc.start()
            self._procs.append(proc)
        for c in child_ends:
            c.close()
        if self._rings:
            for wid, pair in enumerate(self._rings):
                pair.req.deadcheck = pair.rsp.deadcheck = \
                    self._make_deadcheck(wid)

    def _make_deadcheck(self, wid: int):
        def check() -> None:
            if not self._procs[wid].is_alive():
                raise rings.PeerGone(wid)
        return check

    def run_round(self, tasks: list, nev: int) -> None:
        eng = self.scheduler.engine
        comps = eng._components
        nprocs = self.processes
        msgs = self._msgs
        msgs.clear()
        for ctx in tasks:
            group = (ctx.group_id, ctx.window_end,
                     _encode_entries(ctx._adopted, eng))
            msgs.setdefault(ctx.group_id % nprocs, []).append(group)
        ctxs = {ctx.group_id: ctx for ctx in tasks}
        # All ctxs of a wave share one horizons list (None under a
        # global-barrier scheduler); ship it once per worker message.
        horizons = tasks[0].horizons
        pending = self._pending_blobs
        for wid, groups in msgs.items():
            self._send(wid, ("R", groups, pending.pop(wid, ()), horizons))
        for wid in msgs:
            reply = self._recv(wid)
            if reply[0] == "E":
                raise RuntimeError(
                    f"executor worker {wid} failed:\n{reply[1]}")
            for dst_wid, seq, blob, count in reply[2]:
                pending.setdefault(dst_wid, []).append(
                    (wid, seq, blob, count))
            for sid, executed, max_time, posts in reply[1]:
                ctx = ctxs[sid]
                ctx.executed = executed
                ctx.max_time = max_time
                ctx.posts = [
                    (stamp, idx,
                     Event(t, comps[rank], kind,
                           None if pref is None else _Ref(pref)))
                    for stamp, idx, (t, rank, kind, pref) in posts]

    def finalize(self, failed: bool = False) -> None:
        try:
            if not failed and self._conns:
                self._collect()
        finally:
            for wid in range(len(self._conns)):
                try:
                    self._send(wid, ("Q",))
                except (OSError, RuntimeError):
                    pass
            for proc in self._procs:
                proc.join(timeout=5)
                if proc.is_alive():       # pragma: no cover - defensive
                    proc.terminate()
            for conn in self._conns:
                conn.close()
            if self._rings:
                for pair in self._rings:
                    pair.close()
                    pair.unlink()
            self._procs = []
            self._conns = []
            self._rings = None

    def _collect(self) -> None:
        """Sync shard-resident state (and mergeable engine hooks) back
        onto the parent replica, then materialize any payload
        references still queued (a partial run leaves beyond-horizon
        events in the parent queue whose payloads die with the
        workers)."""
        eng = self.scheduler.engine
        comps = eng._components
        for wid in range(len(self._conns)):
            self._send(wid, ("C",))
        caches: dict = {}                 # wid -> leftover local cache
        blob_items: dict = {}             # (src wid, seq) -> payload list
        for wid in range(len(self._conns)):
            msg = wire.loads(self._recv_raw(wid), eng)
            if msg[0] == "E":
                raise RuntimeError(
                    f"executor worker {wid} failed during state "
                    f"collection:\n{msg[1]}")
            _, state, hooks, comp_hooks, local, blobs = msg
            caches[wid] = local
            blob_items.update(blobs)
            for rank, item_state in state.items():
                comps[rank].apply_shard_state(item_state)
            for i, hook in hooks:
                eng._hooks[i].merge_shard(hook)
            for rank, i, hook in comp_hooks:
                comps[rank]._hooks[i].merge_shard(hook)
        # Blobs the parent was still holding for routing decode here.
        for pending in self._pending_blobs.values():
            for src, seq, blob, count in pending:
                blob_items[(src, seq)] = wire.loads(blob, eng)
        self._pending_blobs.clear()
        self._materialize_refs(eng, caches, blob_items)

    def _materialize_refs(self, eng, caches: dict, blob_items: dict) -> None:
        """Replace worker-cache payload references on still-queued
        events with the shipped-back objects (decoded against the
        parent replica, so a future run re-encodes them normally)."""
        nprocs = self.processes
        for shard in eng.queue._shards:
            for entry in shard:
                ev = entry[4]
                p = ev.payload
                if type(p) is not _Ref:
                    continue
                ref = p.ref
                if ref[0] == "L":
                    wid = ev.component.cluster_id % nprocs
                    ev.payload = caches[wid].pop(ref[1])
                else:                     # ("B", src wid, seq, idx)
                    ev.payload = blob_items[(ref[1], ref[2])][ref[3]]

    # -- transport helpers -------------------------------------------------
    def _send(self, wid: int, msg) -> None:
        if self._rings is not None:
            try:
                self._rings[wid].req.send_bytes(_plain_dumps(msg))
            except rings.PeerGone:
                self._died(wid)
            return
        try:
            self._conns[wid].send_bytes(_plain_dumps(msg))
        except OSError:
            self._died(wid)

    def _recv(self, wid: int):
        return _plain_loads(self._recv_raw(wid))

    def _recv_raw(self, wid: int) -> bytes:
        if self._rings is not None:
            try:
                return self._rings[wid].rsp.recv_bytes()
            except rings.PeerGone:
                self._died(wid)
        try:
            return self._conns[wid].recv_bytes()
        except (EOFError, OSError):
            self._died(wid)

    def _died(self, wid: int):
        proc = self._procs[wid]
        proc.join(timeout=1)
        raise RuntimeError(
            f"executor worker {wid} (pid {proc.pid}) died mid-run "
            f"(exit code {proc.exitcode}); simulation state for its "
            f"shards is lost -- rerun with executor='threads' to debug "
            f"the failing handler in-process")

    def describe(self) -> dict:
        return {"name": self.name, "max_workers": self.max_workers,
                "processes": self.processes, "transport": self.transport}


def _encode_entries(entries, eng) -> list:
    """Window entries -> wire tuples.  ``gen`` is dropped (globally
    queued entries always carry generation 0); worker-born payloads
    pass through as references, parent-born ones are wire-encoded."""
    out = []
    for e in entries:
        ev = e[4]
        p = ev.payload
        if p is None:
            pref = None
        elif type(p) is _Ref:
            pref = p.ref
        else:
            pref = ("P", wire.dumps(p, eng))
        out.append((e[0], e[2], e[3], ev.kind, pref))
    return out


register_executor("procs", ProcExecutor)
