"""Serving: the continuous-batching engine (port of ``repro.serve``'s
``Engine`` and ``Request``) and the open-loop serving *simulation*
(``sim``: a timing model on the event engine and fabric, a copy of
``repro/serve/sim.py`` that takes the port's ``ModelConfig``)."""
from .engine import Engine, Request
from .sim import (GENERATORS, ServeReport, ServeRequest, ServeSizing,
                  ServingScenario, ServingSystem, SlotLedger, TenantSpec,
                  build_scenario, bursty_trace, diurnal_trace, make_requests,
                  poisson_trace, run_serving)

__all__ = [
    "Engine", "Request",
    "GENERATORS", "ServeReport", "ServeRequest", "ServeSizing",
    "ServingScenario", "ServingSystem", "SlotLedger", "TenantSpec",
    "build_scenario", "bursty_trace", "diurnal_trace", "make_requests",
    "poisson_trace", "run_serving",
]
