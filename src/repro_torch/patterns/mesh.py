"""A mesh of shards held by one process, with its collectives.

The port's counterpart of three reference pieces together, so it has no
single reference module: ``jax.sharding.Mesh`` over a one-axis ``"dev"``
mesh, ``repro.compat.shard_map`` / ``axis_size``, and the ``jax.lax``
collectives the MGMark patterns use (``ppermute``, ``psum``,
``all_to_all``).

A D-mode program is written over lists of shard tensors, shard ``i`` on
``mesh.devices[i]``; on one card that is ``[cuda:0] * 4``, and the same
code takes four cards.  Every collective copies its payload into new
tensors (it never aliases a shard) and adds the bytes one device sends to
the mesh's counter under ``core/hlo.py``'s kind names, counted as the
reference's HLO parser counts them (operand bytes per device), so the
counts compare like with like with the reference's ``collective_bytes``.
Nothing here moves a shard to the CPU unless the mesh's devices are the
CPU's.

Inside ``repro_torch.core.hlo.analyze``, on ``meta`` shards (placed by
``shard`` / ``replicate``, which tag shard i's tensors for the tracer),
each collective also records one ``CollectiveRecord`` for the program
of every shard, and its own copies are not traced; the counter reads the
same bytes traced or not.
"""
from __future__ import annotations

import math
import typing

import torch

from repro_torch.core import hlo

DEV = "dev"          # the mesh axis; as a spec: split along dimension 0

Shards = typing.List[torch.Tensor]


class Mesh:
    """``devices``: one ``torch.device`` (or name) per shard.  ``axes``
    ({name: size}, in order; default ``{"dev": len(devices)}``) names the
    mesh's axes as ``jax.sharding.Mesh`` does; their sizes multiply to
    the number of devices, which the collectives treat as one axis."""

    def __init__(self, devices: typing.Sequence,
                 axes: typing.Optional[typing.Dict[str, int]] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        # {axis name: size}, as jax.sharding.Mesh.shape
        self.shape = dict(axes) if axes else {DEV: len(self.devices)}
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"axes {self.shape} do not hold "
                             f"{len(self.devices)} devices")
        self.bytes_by_kind: typing.Dict[str, float] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def collective_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def reset_bytes(self) -> None:
        self.bytes_by_kind = {}

    def _count(self, kind: str, xs: Shards, groups=None) -> None:
        per_device = sum(x.numel() * x.element_size() for x in xs)
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) \
            + float(per_device)
        if hlo.tracing():
            hlo.record_collective(kind, per_device, per_device,
                                  groups or [list(range(self.size))])

    def _to(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """A copy of ``x`` on device i (on ``meta``, a meta copy tagged as
        shard i's)."""
        if x.device.type != "meta":
            return x.to(self.devices[i], copy=True)
        out = x.clone()
        hlo.tag(out, i)
        return out

    def _check(self, xs: Shards) -> None:
        if len(xs) != self.size:
            raise ValueError(f"{len(xs)} shards on a mesh of {self.size}")
        shapes = {tuple(x.shape) for x in xs}
        if len(shapes) != 1:
            raise ValueError(f"shards of different shapes: {shapes}")

    # ---- placement (shard_map's in_specs / out_specs) -----------------
    def shard(self, x: torch.Tensor) -> Shards:
        """Split ``x`` along dimension 0 (where every MGMark input is
        split) into ``size`` equal shards (``P("dev")``), shard i a copy
        on device i."""
        if x.shape[0] % self.size:
            raise ValueError(f"dimension 0 of {tuple(x.shape)} does not "
                             f"split over {self.size} shards")
        return [self._to(c, i).contiguous()
                for i, c in enumerate(x.chunk(self.size))]

    def replicate(self, x: torch.Tensor) -> Shards:
        """A copy of ``x`` on every device (``P(None)``)."""
        return [self._to(x, i) for i in range(self.size)]

    def put(self, x, spec) -> Shards:
        x = torch.as_tensor(x)
        return self.shard(x) if spec == DEV else self.replicate(x)

    def unshard(self, xs: Shards, spec) -> torch.Tensor:
        """The global value on ``devices[0]``: shards concatenated for
        ``DEV``, shard 0 for a replicated result."""
        self._check(xs)
        if spec == DEV:
            return torch.cat([x.to(self.devices[0]) for x in xs])
        return xs[0]

    # ---- collectives ----------------------------------------------------
    def ppermute(self, xs: Shards, perm) -> Shards:
        """``jax.lax.ppermute``: shard ``dst`` receives a copy of shard
        ``src`` for each pair ``(src, dst)`` of ``perm``; a shard that no
        pair targets receives zeros.  Traced, its group is the pairs'
        members, as the reference's parser collapses them."""
        self._check(xs)
        out: typing.List[typing.Optional[torch.Tensor]] = [None] * self.size
        with hlo.paused():
            for src, dst in perm:
                if out[dst] is not None:
                    raise ValueError(f"ppermute: two sources for shard {dst}")
                out[dst] = self._to(xs[src], dst)
            for i, o in enumerate(out):
                if o is None:
                    meta = xs[i].device.type == "meta"
                    out[i] = torch.zeros_like(
                        xs[i], device=None if meta else self.devices[i])
                    if meta:
                        hlo.tag(out[i], i)
        self._count("collective-permute", xs[:1],
                    [sorted({d for pair in perm for d in pair})])
        return out

    def psum(self, xs: Shards, *more: Shards):
        """``jax.lax.psum``: every shard receives the sum of all shards
        (summed in shard order on ``devices[0]``, one result for all).
        Given several lists, one all-reduce sums each of them (as XLA's
        all-reduce combiner merges separate psums into one), and a tuple
        of lists comes back."""
        lists = (xs, *more)
        outs = []
        with hlo.paused():
            for ys in lists:
                self._check(ys)
                total = ys[0].to(self.devices[0], copy=True) \
                    if ys[0].device.type != "meta" else ys[0].clone()
                for y in ys[1:]:
                    total += y.to(total.device)
                outs.append([self._to(total, i) for i in range(self.size)])
        self._count("all-reduce", [ys[0] for ys in lists])
        return outs[0] if not more else tuple(outs)

    def all_to_all(self, xs: Shards, split_axis: int = 0,
                   concat_axis: int = 0) -> Shards:
        """``jax.lax.all_to_all(..., tiled=False)``: dimension
        ``split_axis`` (of length ``size``) is split, piece q of shard p
        goes to shard q, and shard q stacks what it receives, in sender
        order, along a new dimension ``concat_axis``."""
        self._check(xs)
        if xs[0].shape[split_axis] != self.size:
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(xs[0].shape)} is not the mesh size "
                             f"{self.size}")
        meta = xs[0].device.type == "meta"
        out = []
        with hlo.paused():
            for q, d in enumerate(self.devices):
                out.append(torch.stack(
                    [x.select(split_axis, q) if meta
                     else x.select(split_axis, q).to(d) for x in xs],
                    dim=concat_axis).contiguous())
                if meta:
                    hlo.tag(out[q], q)
        self._count("all-to-all", xs[:1])
        return out


class Program:
    """One mode of a pattern: ``fn`` with where its arguments and result
    live.  ``in_specs`` None is the global program (U-mode): arguments
    whole on ``devices[0]``, result as ``fn`` returns it.  Otherwise
    (D-mode, made by ``shard_map``) ``fn`` takes one list of shards per
    argument, placed by ``in_specs`` (``DEV`` or None each), and returns
    a list of shards that ``out_specs`` gathers.  ``constraints`` (a
    U-mode program's, made by ``unified.unified``) are the reference's
    sharding constraints: (per-argument spec, output spec)."""

    def __init__(self, fn, mesh: Mesh, in_specs=None, out_specs=None,
                 constraints=None):
        self.fn, self.mesh = fn, mesh
        self.in_specs, self.out_specs = in_specs, out_specs
        self.constraints = constraints

    def place(self, *args):
        if self.in_specs is None:
            return [torch.as_tensor(a).to(self.mesh.devices[0])
                    for a in args]
        if len(args) != len(self.in_specs):
            raise ValueError(f"{len(args)} arguments for "
                             f"{len(self.in_specs)} in_specs")
        return [self.mesh.put(a, s) for a, s in zip(args, self.in_specs)]

    def __call__(self, *placed):
        return self.fn(*placed)

    def gather(self, out) -> torch.Tensor:
        if self.in_specs is None:
            return out
        return self.mesh.unshard(out, self.out_specs)


def shard_map(fn, mesh: Mesh, in_specs, out_specs) -> Program:
    """Port of ``shard_map(local, mesh, in_specs, out_specs)`` for a
    ``fn`` written over lists of shards (``Program``)."""
    return Program(fn, mesh, tuple(in_specs), out_specs)
