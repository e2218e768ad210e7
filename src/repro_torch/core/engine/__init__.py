"""Pluggable-scheduler simulation engine (copy of ``repro/core/engine``
for the port, which imports nothing of ``repro``).

``Engine`` keeps its historical constructor (``parallel=`` maps to the
batch scheduler) plus ``scheduler="serial"|"batch"|"lookahead"|"bounded"``
and accepts any :class:`Scheduler` instance for custom strategies.  Round
schedulers additionally take ``executor="threads"|"procs"`` -- where
grouped rounds run (in-process pool vs shard-resident worker
processes; see :mod:`repro_torch.core.engine.executor`).
"""
from .base import (Engine, Scheduler, RoundScheduler, SCHEDULERS,
                   make_scheduler, register_scheduler)
from .executor import (Executor, EXECUTORS, make_executor,
                       register_executor, ThreadExecutor, ProcExecutor)
from .serial import SerialScheduler
from .batch import BatchParallelScheduler
from .lookahead import LookaheadScheduler, BoundedLagScheduler

__all__ = [
    "Engine", "Scheduler", "RoundScheduler", "SCHEDULERS",
    "make_scheduler", "register_scheduler",
    "Executor", "EXECUTORS", "make_executor", "register_executor",
    "ThreadExecutor", "ProcExecutor",
    "SerialScheduler", "BatchParallelScheduler", "LookaheadScheduler",
    "BoundedLagScheduler",
]
