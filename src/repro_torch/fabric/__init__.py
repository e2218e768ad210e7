"""Pluggable interconnect fabric (copy of ``repro/fabric`` for the port,
which imports nothing of ``repro``): ``make_fabric("analytic", spec)``
resolves a :class:`FabricBackend`, as in the reference.

* ``analytic`` -- closed-form ring/hierarchical/bisection pricing
  (O(1) events per collective; no contention between collectives).
  Same-timestep pricings are batched through the vectorized kernels in
  :mod:`repro_torch.fabric.pricing` (bit-equal to the scalar formulas).

The ``event`` backend (per-hop transfer events with link contention)
and its plan cache are not copied yet: asking for it raises
``ValueError`` naming the later slice.
"""
from . import pricing
from .base import FabricBackend, FabricController
from .analytic import AnalyticFabric

FABRICS: dict = {}
# the reference's other backend, and where the port takes it up
_LATER_FABRICS = ("event",)


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
        if spec_or_name in _LATER_FABRICS:
            raise ValueError(
                f"fabric {spec_or_name!r} is not ported yet: the port has "
                f"{sorted(FABRICS)}; the event fabric and its plan cache "
                f"come with a later slice (ROADMAP §1 item 2)") from None
        raise ValueError(f"unknown fabric {spec_or_name!r}; "
                         f"available: {sorted(FABRICS)}") from None
    return factory(system_spec)


register_fabric("analytic", AnalyticFabric)

__all__ = [
    "FabricBackend", "FabricController", "AnalyticFabric", "FABRICS",
    "register_fabric", "make_fabric", "pricing",
]
