"""Serving: the continuous-batching engine (port of ``repro.serve``'s
``Engine`` and ``Request``; the serving simulator is not ported)."""
from .engine import Engine, Request

__all__ = ["Engine", "Request"]
