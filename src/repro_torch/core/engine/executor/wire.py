"""Wire format shared by process-backed executors.

Events, requests and handler payloads freely reference simulation
objects -- components, connections, ports, the engine itself.  Shipping
them between the scheduler process and a shard worker must NOT copy
that graph: both sides hold a structurally identical replica (the
worker is forked from the parent after ``compute_clusters``), so a
reference is encoded as a *coordinate* into the replica:

* a registered item  -> its ``rank`` (``Engine.register`` order);
* a port             -> ``(owner rank, port name)``;
* the engine         -> a singleton tag.

Everything else in a payload (``Request`` envelopes, ``_Xmit`` routing
stubs, plain tuples/dataclasses) is serialized by value -- payloads are
small, and cross-boundary *identity* of those values is never load
bearing: by the component rules (DP-2/DP-3) a handler only reaches
other components through requests, and requests address their
destination explicitly by reference (here: by rank).

``dumps``/``loads`` are the only entry points; both take the engine
whose replica anchors the coordinates.  Payload bytes produced against
one replica decode against any other replica of the same engine, so a
worker-pickled payload blob can be routed through the parent and
delivered to a different worker untouched -- the parent never decodes
payloads it only forwards (see the reference protocol in
``executor.procs``: ``_Ref`` stubs plus per-destination blob bytes).
"""
from __future__ import annotations

import io
import pickle

from ...component import Port, Registered


class _WirePickler(pickle.Pickler):
    def __init__(self, file, engine) -> None:
        super().__init__(file, protocol=pickle.HIGHEST_PROTOCOL)
        self._engine = engine

    def persistent_id(self, obj):
        # ``obj.engine is not None`` distinguishes a *registered* item
        # (rank is meaningful) from a loose instance, which serializes
        # by value like any other object.
        if isinstance(obj, Registered) and obj.engine is not None:
            return ("r", obj.rank)
        if isinstance(obj, Port):
            return ("p", obj.owner.rank, obj.name)
        if obj is self._engine:
            return ("e",)
        return None


class _WireUnpickler(pickle.Unpickler):
    def __init__(self, file, engine) -> None:
        super().__init__(file)
        self._engine = engine

    def persistent_load(self, pid):
        tag = pid[0]
        if tag == "r":
            return self._engine._components[pid[1]]
        if tag == "p":
            return self._engine._components[pid[1]].port(pid[2])
        if tag == "e":
            return self._engine
        raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")


def dumps(obj, engine) -> bytes:
    buf = io.BytesIO()
    _WirePickler(buf, engine).dump(obj)
    return buf.getvalue()


def loads(data: bytes, engine):
    return _WireUnpickler(io.BytesIO(data), engine).load()


def plain_dumps(obj) -> bytes:
    """Protocol-envelope encoding: plain pickle for messages that by
    construction carry only ints/floats/strings/bytes/tuples (round
    framing, horizons, pre-encoded payload blobs) -- never simulation
    references.  One definition so the pipe and shared-memory ring
    transports speak byte-identical frames."""
    return pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)


def plain_loads(data: bytes):
    return pickle.loads(data)
