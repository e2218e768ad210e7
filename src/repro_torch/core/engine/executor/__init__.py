"""Pluggable executor backends for the round schedulers.

``Executor`` decides *where* a round's grouped cluster work runs --
``threads`` (compatibility default, GIL-bound) or ``procs`` (one worker
process per bucket, shard-resident state, real cores).  The registry
mirrors the scheduler and fabric ones; see docs/engine.md
("Executors") for the residency contract and how to register a third
backend.
"""
from .base import Executor, EXECUTORS, make_executor, register_executor
from .threads import ThreadExecutor
from .procs import ProcExecutor

__all__ = [
    "Executor", "EXECUTORS", "make_executor", "register_executor",
    "ThreadExecutor", "ProcExecutor",
]
