"""Bitonic Sort — Irregular pattern (port of ``repro/patterns/bs.py``).

Every stage touches the whole address space; stages whose compare
distance crosses the shard boundary are pairwise shard exchanges.

D-mode decomposition for L elements on m shards (Ll = L/m local):
  * dist >= Ll: partner shard = mine XOR (dist/Ll); one ``ppermute`` of
    the whole local array per stage; direction and side are fixed per
    (stage, shard), from the shard index;
  * dist < BLOCK: the stage kernel ``ops.bitonic_stage`` with
    ``offset = shard * Ll``, so it sees the direction of its global
    indices (the reference reaches the same with ``_stage_fixed`` when
    size >= Ll);
  * BLOCK <= dist < Ll: the plain stage, with the same offset.
U-mode is the global sort, its stages with dist < BLOCK on the kernel.
The reference's patterns run the plain stage throughout; the port
routes the in-block stages through the kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref

from .mesh import DEV, Program, shard_map

PATTERN = "irregular"
BLOCK = 2048                        # the stage kernel's block (TPU API)


def reference(x: np.ndarray) -> np.ndarray:
    return np.sort(x)


def default_size(n_devices: int) -> int:
    return 32 * 1024 * max(1, n_devices)           # Table 2: 32K -> 128K


def _power_of_two(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _stages(L: int):
    """(size, dist) of every stage of a bitonic sort of L elements."""
    size = 2
    while size <= L:
        dist = size // 2
        while dist >= 1:
            yield size, dist
            dist //= 2
        size *= 2


def _stage(x, dist: int, size: int, offset: int = 0):
    """One stage of a (shard of a) sort: on the kernel where dist < BLOCK
    and the block cut to x's length holds a pair."""
    if dist < min(BLOCK, x.shape[0]):
        return ops.bitonic_stage(x, dist, size, BLOCK, offset=offset)
    return ref.bitonic_stage_ref(x, dist, size, offset)


def sort(x):
    """Bitonic sort of x (L,), L a power of two."""
    if not _power_of_two(x.shape[0]):
        raise ValueError(f"bitonic sort takes a power-of-two length, got "
                         f"{x.shape[0]}")
    for size, dist in _stages(x.shape[0]):
        x = _stage(x, dist, size)
    return x


def make_umode(mesh):
    return Program(sort, mesh)


def make_dmode(mesh):
    m = mesh.size

    def local(xs):
        Ll = xs[0].shape[0]
        if not (_power_of_two(m) and _power_of_two(Ll)):
            raise ValueError(f"bitonic D-mode takes power-of-two shards and "
                             f"shard lengths, got {m} x {Ll}")
        for size, dist in _stages(Ll * m):
            if dist >= Ll:
                shard_dist = dist // Ll
                others = mesh.ppermute(
                    xs, [(i, i ^ shard_dist) for i in range(m)])
                new = []
                for idx, (x, other) in enumerate(zip(xs, others)):
                    # ascending iff (global index & size) == 0: a bit of
                    # the shard index here
                    asc = (idx & (size // Ll)) == 0
                    low_side = idx < (idx ^ shard_dist)
                    new.append(torch.minimum(x, other) if low_side == asc
                               else torch.maximum(x, other))
                xs = new
            else:
                xs = [_stage(x, dist, size, offset=i * Ll)
                      for i, x in enumerate(xs)]
        return xs
    return shard_map(local, mesh, in_specs=(DEV,), out_specs=DEV)


def make_args(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, n).astype(np.float32),)
