"""U-mode traffic: the global program traced as PyTorch's own auto-SPMD
runs it (the port's counterpart of the reference's GSPMD U-mode).

The reference's U-mode is one ``jax.jit`` of the global program with a
``with_sharding_constraint(P("dev"))`` on its inputs, and GSPMD picks the
collectives.  Here the same global program runs on DTensors over a
``DeviceMesh`` of ``n`` ranks in a fake process group (no communication,
no values), its inputs placed ``Shard(0)`` where the reference constrains
them and ``Replicate()`` elsewhere, its output redistributed to the
reference's ``out_shardings``.  ``core.hlo.analyze`` hands each DTensor op
back to DTensor, so it records rank 0's local program: its local ops and
the functional collectives DTensor issues, one device's program.

A hand-written kernel takes plain tensors: ``local`` reaches it through
``local_map`` with the placements it needs, so the redistribution a
unified runtime would make in front of it is traced too.  On plain
tensors (the correctness run, the global program on one device) ``local``
and the constraints do nothing.
"""
from __future__ import annotations

import contextlib
import typing

import torch

from repro_torch.core import hlo

from .mesh import DEV, Mesh, Program


def unified(fn, mesh: Mesh, in_specs, out_specs) -> Program:
    """The U-mode ``Program`` of a global ``fn``: it runs whole on
    ``mesh.devices[0]``; ``in_specs`` (``DEV`` or None per argument) and
    ``out_specs`` are the reference's sharding constraints, read only by
    ``trace``."""
    return Program(fn, mesh, constraints=(tuple(in_specs), out_specs))


def _placements(spec):
    from torch.distributed.tensor import Replicate, Shard
    return (Shard(0),) if spec == DEV else (Replicate(),)


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def local(fn, in_specs, out_specs):
    """``fn`` (plain tensors in, one tensor out) as one device's program
    inside a unified run: on DTensor arguments, ``local_map`` with each
    argument redistributed to ``in_specs`` (``DEV``: split along
    dimension 0, None: whole; plain tensors pass as they are) and the
    result placed by ``out_specs``; on plain tensors, ``fn`` itself."""
    def call(*args):
        if not any(_is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor.experimental import local_map
        return local_map(fn, out_placements=(_placements(out_specs),),
                         in_placements=tuple(
                             _placements(s) if _is_dtensor(a) else None
                             for a, s in zip(args, in_specs)),
                         redistribute_inputs=True)(*args)
    call.__name__ = getattr(fn, "__name__", "local")
    return call


@contextlib.contextmanager
def fake_mesh(n: int):
    """A ``DeviceMesh`` of ``n`` ranks over the fake process group (rank
    0), torn down on exit.  Refuses to run beside a process group that
    already exists."""
    import sys
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "U-mode trace needs its own fake one")
    hook = sys.excepthook        # init_process_group wraps it for its rank
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cuda", list(range(n)))
    finally:
        dist.destroy_process_group()
        sys.excepthook = hook


def trace(prog: Program, args: typing.Sequence[torch.Tensor]) -> hlo.HloCost:
    """Rank 0's trace of U-mode ``prog`` on ``args`` (global ``meta``
    tensors), placed by its constraints, its output redistributed to its
    ``out_specs``."""
    from torch.distributed.tensor import DTensor
    in_specs, out_specs = prog.constraints
    n = prog.mesh.size
    with fake_mesh(n) as dm:
        dts = []
        for a, spec in zip(args, in_specs):
            if spec == DEV:
                if a.shape[0] % n:
                    raise ValueError(f"dimension 0 of {tuple(a.shape)} does "
                                     f"not split over {n} ranks")
                a = a.new_empty((a.shape[0] // n, *a.shape[1:]))
            dts.append(DTensor.from_local(a, dm, _placements(spec),
                                          run_check=False))
            # rank 0's tensors: the tracer keeps the ops that descend from
            # them, and leaves out DTensor's own work on placeholders
            hlo.tag(dts[-1]._local_tensor, 0)

        def run(*xs):
            return prog.fn(*xs).redistribute(dm, _placements(out_specs))
        return hlo.analyze(run, *dts)
