"""Executor interface + registry (mirrors the scheduler/fabric ones).

A :class:`~repro.core.engine.base.RoundScheduler` decides *what* runs
each round -- the window, the per-cluster grouping, the commit order.
An :class:`Executor` decides *where* the grouped work runs:

* ``threads`` -- the compatibility default: a ``ThreadPoolExecutor``
  with sticky ``cluster_id % max_workers`` buckets.  Correct always;
  under CPython's GIL pure-Python handlers gain no physical speedup.
* ``procs``   -- one long-lived worker *process* per bucket.  Each
  cluster's components are shard-resident: handlers run on the worker's
  replica (real cores, no GIL), and only compact per-round messages
  cross the boundary -- window event entries in, ``(commit stamps,
  beyond-window posts, cross-cluster sends)`` out.  See
  ``repro.core.engine.executor.procs``.

A third backend is one :func:`register_executor` call away (see
docs/engine.md, "Executors").
"""
from __future__ import annotations

import typing


class Executor:
    """Strategy object that runs one round's grouped cluster contexts.

    Lifecycle: the scheduler resolves its ``executor_spec`` in
    ``prepare()`` (one executor instance per ``run``), calls
    :meth:`prepare` once, :meth:`run_round` once per grouped round, and
    :meth:`finalize` in the run's ``finally`` block.

    ``inline_rounds`` declares whether the scheduler thread may execute
    events itself (the adaptive merged / degenerate serial-equivalent
    paths).  Executors with shard-resident state must say ``False``:
    every handler activation has to happen where the component's
    authoritative state lives, so *all* rounds -- however narrow --
    route through :meth:`run_round`.
    """

    name = "abstract"
    inline_rounds = True

    def __init__(self, max_workers: int = 4) -> None:
        self.max_workers = max_workers
        self.scheduler = None

    def bind(self, scheduler) -> "Executor":
        self.scheduler = scheduler
        return self

    def prepare(self, ctxs: list) -> None:
        """Called once per run, after clusters + contexts exist."""

    def run_round(self, tasks: list, nev: int) -> None:
        """Execute one grouped round: every context in ``tasks`` has
        adopted its window slice (``ctx.begin``); on return each must
        carry ``executed`` / ``max_time`` / ``posts`` exactly as
        ``_GroupCtx.execute`` leaves them."""
        raise NotImplementedError

    def finalize(self, failed: bool = False) -> None:
        """Tear down after a run.  ``failed`` is True when the run is
        unwinding an exception -- skip result collection, just release
        resources."""

    def describe(self) -> dict:
        return {"name": self.name}


EXECUTORS: dict = {}


def register_executor(name: str, factory) -> None:
    """Make ``Engine(executor=name)`` resolve to ``factory(max_workers=N)``."""
    EXECUTORS[name] = factory


def make_executor(spec, max_workers: int = 4) -> Executor:
    """Resolve an executor name (or pass through an instance)."""
    if isinstance(spec, Executor):
        return spec
    try:
        factory = EXECUTORS[spec]
    except KeyError:
        raise ValueError(f"unknown executor {spec!r}; "
                         f"available: {sorted(EXECUTORS)}") from None
    return factory(max_workers=max_workers)
