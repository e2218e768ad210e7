"""Sharding programming models (port of ``repro/sharding``).  So far only
the single-process training step of U-mode; the mesh, the partition
specs and D-mode come with the LM-sharding slice."""
from . import umode

__all__ = ["umode"]
