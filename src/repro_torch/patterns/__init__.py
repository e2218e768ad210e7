"""MGMark on the port: the paper's benchmark suite over a mesh of shards
(port of ``repro/patterns/``).

Seven workloads across the five collaborative-execution patterns
(paper Sec. 5):

  AES  partitioned   KM  partitioned   FIR  adjacent   SC  adjacent
  GD   gather        MT  scatter       BS   irregular

Each module: an oracle, U-mode (the global program on one device, the
paper's U-MGPU) and D-mode (over the mesh's shards, every collective
explicit, D-MGPU).  ``mesh.Mesh`` is the shard mesh; SC and BS run the
hand-written stencil and bitonic-stage kernels.
"""
from . import aes, base, bs, fir, gd, km, mesh, mt, sc
from .base import PatternReport, evaluate
from .mesh import Mesh

WORKLOADS = {"aes": aes, "km": km, "fir": fir, "sc": sc, "gd": gd,
             "mt": mt, "bs": bs}

__all__ = ["aes", "base", "bs", "fir", "gd", "km", "mesh", "mt", "sc",
           "Mesh", "WORKLOADS", "PatternReport", "evaluate"]
