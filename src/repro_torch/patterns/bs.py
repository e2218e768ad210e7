"""Bitonic Sort — Irregular pattern (port of ``repro/patterns/bs.py``).

Every stage touches the whole address space; stages whose compare
distance crosses the shard boundary are pairwise shard exchanges.

A sort runs its stages in ``_stages`` order, grouped into launches by
``_steps`` with tiles of T = min(BLOCK, local length) elements:
  * one ``ops.bitonic_block`` launch for the whole of phases 2..T, and
    one for the tail dist = T/2 .. 1 of each later phase (shared memory,
    each tile loaded and stored once);
  * one ``ops.bitonic_stage`` launch for each stage with dist >= T.
D-mode decomposition for L elements on m shards (Ll = L/m local):
  * dist >= Ll: partner shard = mine XOR (dist/Ll); one ``ppermute`` of
    the whole local array per stage; direction and side are fixed per
    (stage, shard), from the shard index;
  * dist < Ll: the launches above with ``offset = shard * Ll``, so they
    see the direction of their global indices (the reference reaches the
    same with ``_stage_fixed`` when size >= Ll).
U-mode is the global sort.  The reference's patterns run the plain stage
throughout; the port runs no plain stage on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from .mesh import DEV, shard_map
from .unified import local, unified

PATTERN = "irregular"
BLOCK = 2048                        # the TPU API's block: the block kernel's tile


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


def _steps(L: int, tile: int):
    """The launches of a sort of L elements with tiles of ``tile``, in
    order: ("block", size) for one ``bitonic_block`` launch (its stages
    are ``ref.bitonic_block_stages(size, tile)``), ("stage", size, dist)
    for one stage with dist >= tile.  Expanded, they are ``_stages(L)``."""
    if tile >= 2:
        yield ("block", tile)
    size = 2 * tile
    while size <= L:
        dist = size // 2
        while dist >= tile:
            yield ("stage", size, dist)
            dist //= 2
        if tile >= 2:
            yield ("block", size)
        size *= 2


def _run(x, step, tile: int, offset: int = 0):
    """One launch of ``_steps`` on (a shard of) the array."""
    if step[0] == "block":
        return ops.bitonic_block(x, step[1], tile, offset=offset)
    _, size, dist = step
    return ops.bitonic_stage(x, dist, size, x.shape[0], offset=offset)


def sort(x):
    """Bitonic sort of x (L,), L a power of two."""
    L = x.shape[0]
    if not _power_of_two(L):
        raise ValueError(f"bitonic sort takes a power-of-two length, got {L}")
    tile = min(BLOCK, L)
    for step in _steps(L, tile):
        x = _run(x, step, tile)
    return x


def make_umode(mesh):
    # the kernels take the whole array
    return unified(local(sort, (None,), None), mesh, in_specs=(DEV,),
                   out_specs=DEV)


def make_dmode(mesh):
    m = mesh.size

    def local(xs):
        Ll = xs[0].shape[0]
        if not (_power_of_two(m) and _power_of_two(Ll)):
            raise ValueError(f"bitonic D-mode takes power-of-two shards and "
                             f"shard lengths, got {m} x {Ll}")
        tile = min(BLOCK, Ll)
        for step in _steps(Ll * m, tile):
            if step[0] == "stage" and step[2] >= Ll:
                _, size, dist = step
                shard_dist = dist // Ll
                others = mesh.ppermute(
                    xs, [(i, i ^ shard_dist) for i in range(m)])
                new = []
                for idx, (x, other) in enumerate(zip(xs, others)):
                    # ascending iff (global index & size) == 0: a bit of
                    # the shard index here
                    asc = (idx & (size // Ll)) == 0
                    low_side = idx < (idx ^ shard_dist)
                    # both sides on every shard, as the reference's
                    # jnp.where(take_min, minimum, maximum)
                    lo, hi = torch.minimum(x, other), torch.maximum(x, other)
                    new.append(lo if low_side == asc else hi)
                xs = new
            else:
                xs = [_run(x, step, tile, offset=i * Ll)
                      for i, x in enumerate(xs)]
        return xs
    return shard_map(local, mesh, in_specs=(DEV,), out_specs=DEV)


def make_args(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, n).astype(np.float32),)
