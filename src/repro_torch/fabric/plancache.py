"""Content-hashed cache of decomposed collective plans.

``repro.fabric.event.decompose`` is pure: the per-chip DMA programs it
emits are a function of the topology geometry/bandwidth parameters and
the ``(kind, bytes, group)`` triple.  A sweep replays the *same*
collectives thousands of times -- every grid point over a scenario
re-decomposes the identical plans -- so the decomposition is cached
under a content hash of exactly those inputs:

* **in-memory** per process (every repeated plan inside one run or one
  long-lived sweep worker is a hit);
* optionally **on disk** (:func:`configure`): sweep workers share one
  cache directory, and a *repeat* sweep run hits the persisted plans
  without calling ``decompose`` at all -- the hit rate is recorded in
  ``BENCH_fabric.json``'s ``sweep`` section.

Cached programs are shared objects and must be treated as read-only by
callers (the event controller already copies before filtering; the
steps themselves are frozen dataclasses).  Pickle is the disk format:
the cache directory is a private artifact of the local sweep, not an
interchange format -- delete it freely, it repopulates.

The port's disk files (its one departure from a verbatim copy of
``repro/fabric/plancache.py``) end in ``.torchplan``, not ``.plan``:
the plan key is a content hash, equal for the port and the reference,
and a reference plan unpickled here would import ``repro.fabric.event``.
So a cache directory both packages point at holds two sets of files
that never match each other's lookups, and each package's ``clear``
deletes only its own.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import typing

_mem: dict = {}
_disk_dir: typing.Optional[str] = None
_stats = {"hits": 0, "disk_hits": 0, "misses": 0}
# the port's own disk namespace (see the module docstring)
SUFFIX = ".torchplan"


def plan_key(topo, kind: str, B: float, group) -> str:
    """Content hash of everything a decomposition depends on: topology
    geometry + bandwidth/latency parameters + the collective triple.
    Two sweeps (or two processes) with equal specs share keys."""
    spec = topo.spec
    c = spec.chip
    blob = repr((tuple(spec.pod_shape), spec.num_pods,
                 c.ici_link_bandwidth, c.ici_hop_latency_s,
                 c.dcn_latency_s, spec.dcn_bandwidth_per_pod,
                 spec.bisection_bandwidth_per_pod,
                 kind, float(B), tuple(group)))
    return hashlib.sha256(blob.encode()).hexdigest()


def configure(directory: typing.Optional[str]) -> None:
    """Enable (or, with ``None``, disable) the on-disk tier.  Creates
    the directory; safe to call from every sweep worker."""
    global _disk_dir
    if directory is not None:
        os.makedirs(directory, exist_ok=True)
    _disk_dir = directory


def cached_decompose(topo, kind: str, B: float,
                     group: typing.List[int]) -> dict:
    """``decompose`` with content-hashed memoization (same plan key ->
    skip ``decompose()``).  The returned programs are shared: do not
    mutate them."""
    from .event import decompose      # late: avoid import cycle
    key = plan_key(topo, kind, B, group)
    plans = _mem.get(key)
    if plans is not None:
        _stats["hits"] += 1
        return plans
    if _disk_dir is not None:
        path = os.path.join(_disk_dir, key + SUFFIX)
        try:
            with open(path, "rb") as f:
                plans = pickle.load(f)
        except (OSError, pickle.PickleError, EOFError):
            plans = None
        if plans is not None:
            _mem[key] = plans
            _stats["disk_hits"] += 1
            return plans
    plans = decompose(topo, kind, float(B), list(group))
    _mem[key] = plans
    _stats["misses"] += 1
    if _disk_dir is not None:
        # atomic publish: a parallel worker reading a half-written plan
        # would poison its run, so write aside and rename into place
        fd, tmp = tempfile.mkstemp(dir=_disk_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(plans, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, os.path.join(_disk_dir, key + SUFFIX))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return plans


def stats() -> dict:
    """Counters since process start / last :func:`reset_stats`.  Both
    hit tiers count as hits for the headline rate."""
    hits = _stats["hits"] + _stats["disk_hits"]
    total = hits + _stats["misses"]
    return {**_stats, "lookups": total,
            "hit_rate": (hits / total) if total else 0.0}


def reset_stats() -> None:
    for k in _stats:
        _stats[k] = 0


def clear(memory: bool = True, disk: bool = False) -> None:
    """Drop cached plans (testing / cache-dir hygiene)."""
    if memory:
        _mem.clear()
    if disk and _disk_dir is not None:
        for name in os.listdir(_disk_dir):
            if name.endswith(SUFFIX):
                try:
                    os.unlink(os.path.join(_disk_dir, name))
                except OSError:
                    pass
