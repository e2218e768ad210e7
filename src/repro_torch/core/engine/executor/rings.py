"""Shared-memory SPSC ring buffers for the procs executor's round traffic.

A pipe round trip on a loaded host costs ~100-400us in wakeup latency
and syscall overhead -- paid *twice per round* per worker by the procs
executor, which is exactly the "round-barrier tax" the bounded-lag
scheduler attacks from the scheduling side.  This module attacks the
transport side: each parent<->worker direction becomes one
single-producer / single-consumer byte ring over
``multiprocessing.shared_memory``, so handing a round's message to a
spinning peer costs two memcpys and a pair of counter stores instead of
a syscall + scheduler wakeup.

Layout of one ring (one direction)::

    [ tail u64 | pad | head u64 | pad | data[capacity] ]

``tail`` counts total bytes ever written (producer-owned), ``head``
total bytes ever read (consumer-owned); both are monotonic, so
fullness is ``tail - head`` with no empty/full ambiguity, and each
cache line has exactly one writer.  Frames are ``u32 length`` +
payload, written as a circular byte stream -- a frame larger than the
remaining (or even total) capacity simply streams through the ring in
chunks while the consumer drains it, so capacity only affects speed,
never correctness.

Counter publication (the port's one departure from a verbatim copy of
``repro/core/engine/executor/rings.py``): each counter is stored and
loaded as one aligned 8-byte word through a ``memoryview`` cast to
``"Q"`` over the header (``_ctr``).  The reference publishes with
``struct.pack_into``, and CPython's ``pack_into`` zeroes the field before
it writes the field, so a peer reading between the two saw 0 (or a torn
value), ``avail = tail - head`` went negative and the worker died on
``struct.error``.  A memoryview item store is one ``memcpy`` of 8 bytes
into an 8-aligned slot, a single store the peer sees whole.  Nothing
clamps a read: with no torn write there is nothing to clamp, and a
clamp would hide a real fault.

Progress/visibility contract: CPython executes the data copy before
the counter store (bytecode order) and both sides run under their own
GIL, which on the strongly-ordered platforms the fork start method
exists on (POSIX) makes the counter publication act as the release of
the preceding copy.  Waiting sides spin briefly, then back off to
micro-sleeps; a ``deadcheck`` callback (checked on the slow path) lets
the parent turn a dead worker into an exception instead of a hang.

``Ring`` objects are created by the parent *before* forking; the child
inherits the mapping.  Only the creating side should ``unlink``.
"""
from __future__ import annotations

import os
import struct
import time
import typing

try:                                        # gate: absent on some platforms
    from multiprocessing import shared_memory as _shm
except ImportError:                         # pragma: no cover - exotic builds
    _shm = None

_TAIL_OFF = 0
_HEAD_OFF = 64
_DATA_OFF = 128
_TAIL = _TAIL_OFF // 8                      # word indices into ``_ctr``
_HEAD = _HEAD_OFF // 8
_LEN = struct.Struct("<I")

DEFAULT_CAPACITY = 1 << 20                  # 1 MiB per direction

# Busy-waiting only pays when the peer can actually run on another CPU;
# on a single-CPU host a spinning waiter blocks the very process it is
# waiting for until the scheduler preempts it, so yield immediately.
_HOT_SPINS = 2000 if (os.cpu_count() or 1) > 1 else 0
_sched_yield = getattr(os, "sched_yield", None) or (lambda: time.sleep(0))


def available() -> bool:
    """True when shared-memory rings can be used on this host."""
    return _shm is not None


class PeerGone(RuntimeError):
    """Raised by a blocking ring operation when ``deadcheck`` reports
    the other side of the ring is gone."""


class Ring:
    """One SPSC byte ring.  Exactly one process calls ``send_bytes``,
    exactly one calls ``recv_bytes`` (they may be the same process only
    in tests).  ``deadcheck`` -- if set -- is invoked on the blocking
    slow path and should raise :class:`PeerGone` when the peer died."""

    __slots__ = ("shm", "capacity", "_data", "_buf", "_ctr", "tail",
                 "head", "deadcheck", "_owner")

    def __init__(self, capacity: int = DEFAULT_CAPACITY, name: str = None):
        if _shm is None:                    # pragma: no cover - gated earlier
            raise RuntimeError("multiprocessing.shared_memory unavailable")
        self.capacity = capacity
        if name is None:
            self.shm = _shm.SharedMemory(create=True,
                                         size=_DATA_OFF + capacity)
            self._owner = True
        else:                               # attach (non-fork peers)
            self.shm = _shm.SharedMemory(name=name)
            self._owner = False
        self._buf = self.shm.buf
        self._data = self.shm.buf[_DATA_OFF:_DATA_OFF + capacity]
        # the counters as aligned 8-byte words: one store publishes one
        self._ctr = self.shm.buf[:_DATA_OFF].cast("Q")
        if self._owner:
            self._ctr[_TAIL] = 0
            self._ctr[_HEAD] = 0
        # Local mirrors of the counters this side owns/last observed --
        # the shared copies are only touched to publish/refresh.
        self.tail = self._ctr[_TAIL]
        self.head = self._ctr[_HEAD]
        self.deadcheck: typing.Optional[typing.Callable] = None

    # -- blocking helpers --------------------------------------------------
    def _wait(self, spins: int) -> int:
        """One step of the spin -> yield -> micro-sleep backoff; returns
        the incremented spin counter.  Checks ``deadcheck`` once the
        wait leaves the hot spin (a dead peer never publishes again)."""
        if spins < _HOT_SPINS:
            return spins + 1
        if self.deadcheck is not None and spins % 64 == 0:
            self.deadcheck()
        if spins < _HOT_SPINS + 500:
            _sched_yield()                  # cede the CPU to the peer
        else:
            time.sleep(0.00005 if spins < _HOT_SPINS + 4000 else 0.0005)
        return spins + 1

    # -- producer side -----------------------------------------------------
    def send_bytes(self, payload: bytes) -> None:
        # One frame, one publish: the length-prefix concat is cheaper
        # than a second publish + the consumer waking up between them.
        self._write(_LEN.pack(len(payload)) + payload)

    def _write(self, data) -> None:
        buf, cap = self._data, self.capacity
        tail = self.tail
        n = len(data)
        head = self._ctr[_HEAD]
        pos = tail % cap
        if cap - (tail - head) >= n and cap - pos >= n:
            buf[pos:pos + n] = data          # contiguous, fits: fast path
            tail += n
            self.tail = tail
            self._ctr[_TAIL] = tail                 # publish
            return
        mv = memoryview(data)
        spins = 0
        while mv.nbytes:
            head = self._ctr[_HEAD]
            free = cap - (tail - head)
            if not free:
                spins = self._wait(spins)
                continue
            spins = 0
            k = min(free, mv.nbytes)
            pos = tail % cap
            first = min(k, cap - pos)
            buf[pos:pos + first] = mv[:first]
            if k > first:
                buf[:k - first] = mv[first:k]
            tail += k
            self.tail = tail
            self._ctr[_TAIL] = tail                 # publish
            mv = mv[k:]

    # -- consumer side -----------------------------------------------------
    def recv_bytes(self) -> bytes:
        buf, cap = self._data, self.capacity
        head = self.head
        pos = head % cap
        if cap - pos >= 4 and \
                self._ctr[_TAIL] - head >= 4:
            n = _LEN.unpack_from(buf, pos)[0]
            if cap - pos - 4 >= n and \
                    self._ctr[_TAIL] - head >= 4 + n:
                out = bytes(buf[pos + 4:pos + 4 + n])    # fast path
                self.head = head + 4 + n
                self._ctr[_HEAD] = self.head  # publish
                return out
        n = _LEN.unpack(self._read(4))[0]
        return self._read(n)

    def poll(self) -> bool:
        """True when at least one byte is ready (non-blocking)."""
        return self._ctr[_TAIL] > self.head

    def _read(self, n: int) -> bytes:
        out = bytearray(n)
        buf, cap = self._data, self.capacity
        head = self.head
        got = 0
        spins = 0
        while got < n:
            tail = self._ctr[_TAIL]
            avail = tail - head
            if not avail:
                spins = self._wait(spins)
                continue
            spins = 0
            k = min(avail, n - got)
            pos = head % cap
            first = min(k, cap - pos)
            out[got:got + first] = buf[pos:pos + first]
            if k > first:
                out[got + first:got + k] = buf[:k - first]
            head += k
            self.head = head
            self._ctr[_HEAD] = head                 # publish
            got += k
        return bytes(out)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._ctr.release()
        self._data.release()
        self._buf.release()
        self.shm.close()

    def unlink(self) -> None:
        if self._owner:
            self.shm.unlink()


class RingPair:
    """The parent's view of one worker's duplex channel: ``req`` is
    written by the parent and drained by the worker, ``rsp`` the
    reverse.  Created before the fork; the child reuses the same object
    through the inherited mapping."""

    __slots__ = ("req", "rsp")

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.req = Ring(capacity)
        self.rsp = Ring(capacity)

    def close(self) -> None:
        self.req.close()
        self.rsp.close()

    def unlink(self) -> None:
        self.req.unlink()
        self.rsp.unlink()


# -- IPC microbenchmarks ------------------------------------------------------

def _echo_child_rings(pair: "RingPair") -> None:  # pragma: no cover - child
    import os
    try:
        while True:
            msg = pair.req.recv_bytes()
            if not msg:
                break
            pair.rsp.send_bytes(msg)
    finally:
        os._exit(0)


def ring_rtt_us(reps: int = 400, size: int = 256) -> float:
    """Median-free best-effort ring round-trip latency in microseconds:
    one ``size``-byte message to a forked echo child and back, averaged
    over ``reps`` round trips (first quarter discarded as warmup)."""
    import multiprocessing
    if not available() or \
            "fork" not in multiprocessing.get_all_start_methods():
        return float("nan")
    mp = multiprocessing.get_context("fork")
    pair = RingPair(capacity=1 << 16)
    proc = mp.Process(target=_echo_child_rings, args=(pair,), daemon=True)
    proc.start()
    payload = b"x" * size
    try:
        for _ in range(reps // 4):          # warmup
            pair.req.send_bytes(payload)
            pair.rsp.recv_bytes()
        t0 = time.perf_counter()
        for _ in range(reps):
            pair.req.send_bytes(payload)
            pair.rsp.recv_bytes()
        dt = time.perf_counter() - t0
    finally:
        pair.req.send_bytes(b"")
        proc.join(timeout=5)
        if proc.is_alive():                 # pragma: no cover - defensive
            proc.terminate()
        pair.close()
        pair.unlink()
    return dt / reps * 1e6


def _echo_child_pipe(conn) -> None:  # pragma: no cover - child
    import os
    try:
        while True:
            msg = conn.recv_bytes()
            if not msg:
                break
            conn.send_bytes(msg)
    finally:
        os._exit(0)


def pipe_rtt_us(reps: int = 400, size: int = 256) -> float:
    """Pipe round-trip latency in microseconds, same protocol as
    :func:`ring_rtt_us` so the two numbers are directly comparable --
    this is the per-round tax the rings remove."""
    import multiprocessing
    if "fork" not in multiprocessing.get_all_start_methods():
        return float("nan")
    mp = multiprocessing.get_context("fork")
    parent, child = mp.Pipe(duplex=True)
    proc = mp.Process(target=_echo_child_pipe, args=(child,), daemon=True)
    proc.start()
    child.close()
    payload = b"x" * size
    try:
        for _ in range(reps // 4):          # warmup
            parent.send_bytes(payload)
            parent.recv_bytes()
        t0 = time.perf_counter()
        for _ in range(reps):
            parent.send_bytes(payload)
            parent.recv_bytes()
        dt = time.perf_counter() - t0
    finally:
        parent.send_bytes(b"")
        proc.join(timeout=5)
        if proc.is_alive():                 # pragma: no cover - defensive
            proc.terminate()
        parent.close()
    return dt / reps * 1e6
