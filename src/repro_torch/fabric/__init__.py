"""Pluggable interconnect fabric (copy of ``repro/fabric`` for the port,
which imports nothing of ``repro``): ``make_fabric("analytic" |
"event", spec)`` resolves a :class:`FabricBackend`, as in the reference.

* ``analytic`` -- closed-form ring/hierarchical/bisection pricing
  (O(1) events per collective; no contention between collectives).
  Same-timestep pricings are batched through the vectorized kernels in
  :mod:`repro_torch.fabric.pricing` (bit-equal to the scalar formulas).
* ``event``    -- per-hop transfer events on link / DMA-engine
  components; concurrent collectives queue on shared links.
  Decompositions are memoized by content hash
  (:mod:`repro_torch.fabric.plancache`, whose disk files are the port's
  own: they never match a reference plan).
"""
from . import plancache, pricing
from .base import FabricBackend, FabricController
from .analytic import AnalyticFabric
from .event import (EventFabric, FabricLink, DmaEngine, DmaStep, Legs,
                    Xfer, decompose, make_legs)
from .plancache import cached_decompose

FABRICS: dict = {}


def register_fabric(name: str, factory) -> None:
    """Make ``make_fabric(name, spec)`` resolve to ``factory(spec)``."""
    FABRICS[name] = factory


def make_fabric(spec_or_name, system_spec) -> FabricBackend:
    """Resolve a fabric name (or pass through a backend instance)."""
    if isinstance(spec_or_name, FabricBackend):
        return spec_or_name
    try:
        factory = FABRICS[spec_or_name]
    except KeyError:
        raise ValueError(f"unknown fabric {spec_or_name!r}; "
                         f"available: {sorted(FABRICS)}") from None
    return factory(system_spec)


register_fabric("analytic", AnalyticFabric)
register_fabric("event", EventFabric)

__all__ = [
    "FabricBackend", "FabricController", "AnalyticFabric", "EventFabric",
    "FabricLink", "DmaEngine", "DmaStep", "Legs", "Xfer", "decompose",
    "cached_decompose", "make_legs", "FABRICS", "register_fabric",
    "make_fabric", "plancache", "pricing",
]
