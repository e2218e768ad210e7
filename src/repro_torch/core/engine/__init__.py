"""Simulation engine (copy of ``repro/core/engine`` for the port): the
engine, the scheduler registry and the serial scheduler.  The round
schedulers (``batch``, ``lookahead``, ``bounded``) and the executor
backends are not copied yet; asking for them raises ``ValueError``
(``base.make_scheduler``)."""
from .base import (Engine, Scheduler, SCHEDULERS, make_scheduler,
                   register_scheduler)
from .serial import SerialScheduler

__all__ = ["Engine", "Scheduler", "SCHEDULERS", "make_scheduler",
           "register_scheduler", "SerialScheduler"]
