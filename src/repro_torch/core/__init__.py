"""The simulator core on the port's side: the MGSim system model and the
cost front end that feeds it (port of ``repro/core``).

Everything but the front end is a copy of the reference's pure-Python
modules (``hw``, ``topology``, ``event``, ``hooks``, ``component``,
``connection``, ``chip``, ``system``, ``trace``, ``simulate``,
``roofline``, the engine with its serial and round schedulers and its
thread and process executors), verbatim but for their import lines and
one stated departure: the process executor's ring publishes each
counter with one 8-byte store (``engine/executor/rings.py``).  The
arithmetic is the reference's, held to it with ``==``
(``tests/test_torch_core.py``, ``tests/test_torch_sim_engine.py``).
The front end,
``hlo.analyze(fn, *args)``, traces a torch program into the reference's
``HloCost`` records in place of parsing XLA's HLO text.
"""
from .event import (Event, EventQueue, ShardedEventQueue, LocalQueue,
                    EmptyQueueError)
from .engine import (Engine, Scheduler, RoundScheduler, SCHEDULERS,
                     make_scheduler, register_scheduler, SerialScheduler,
                     BatchParallelScheduler, LookaheadScheduler,
                     BoundedLagScheduler,
                     Executor, EXECUTORS, make_executor, register_executor,
                     ThreadExecutor, ProcExecutor)
from .component import Component, Port
from .connection import (Connection, LagNode, LinkConnection,
                         LimitedConnection, Request)
from .hooks import (Hook, HookCtx, Hookable, Tracer, MetricsHook, StallHook,
                    FaultInjector, EVENT_START, EVENT_END, REQ_SEND,
                    REQ_DELIVER, BUSY_INTERVAL)
from .hw import (ChipSpec, SystemSpec, SINGLE_POD, MULTI_POD, DTYPE_BYTES,
                 s_to_ps, ps_to_s)
from .topology import Topology, parse_replica_groups
from .chip import TensorCore, HbmController, ComputeJob
from .system import System, DeviceProgram, CollectiveCoordinator
from .hlo import (HloCost, CollectiveRecord, TraceOp, analyze, cost_analysis,
                  matmul_flops)
from .trace import build_runops
from .simulate import SimReport, simulate, what_if_straggler, what_if_failure
from .roofline import (RooflineTerms, build_terms, collective_sim_time,
                       model_flops_train, model_flops_prefill,
                       model_flops_decode, attention_flops, format_table)

__all__ = [
    "Event", "EventQueue", "ShardedEventQueue", "LocalQueue",
    "EmptyQueueError", "Engine", "Scheduler",
    "RoundScheduler", "SCHEDULERS", "make_scheduler", "register_scheduler",
    "Executor", "EXECUTORS", "make_executor", "register_executor",
    "ThreadExecutor", "ProcExecutor",
    "SerialScheduler", "BatchParallelScheduler", "LookaheadScheduler",
    "BoundedLagScheduler",
    "Component", "Port",
    "Connection", "LagNode", "LinkConnection", "LimitedConnection", "Request",
    "Hook", "HookCtx", "Hookable", "Tracer", "MetricsHook", "StallHook",
    "FaultInjector", "EVENT_START", "EVENT_END", "REQ_SEND", "REQ_DELIVER",
    "BUSY_INTERVAL",
    "ChipSpec", "SystemSpec", "SINGLE_POD", "MULTI_POD", "DTYPE_BYTES",
    "s_to_ps", "ps_to_s",
    "Topology", "parse_replica_groups",
    "TensorCore", "HbmController", "ComputeJob",
    "System", "DeviceProgram", "CollectiveCoordinator",
    "HloCost", "CollectiveRecord", "TraceOp", "analyze", "cost_analysis",
    "matmul_flops", "build_runops",
    "SimReport", "simulate", "what_if_straggler", "what_if_failure",
    "RooflineTerms", "build_terms", "collective_sim_time",
    "model_flops_train", "model_flops_prefill", "model_flops_decode",
    "attention_flops", "format_table",
]
