"""FIR filter — Adjacent Access pattern (port of
``repro/patterns/fir.py``).

Causal FIR over a partitioned signal: each shard needs the previous
shard's last (taps-1) samples.  D-mode moves exactly that halo with one
``ppermute``; U-mode is the global convolution on one device.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import DEV, shard_map
from .unified import unified

PATTERN = "adjacent"
TAPS = 16


def _fir_local(x, taps):
    """x already left-padded with (T-1) halo samples: y_i = sum taps_j *
    x[i + T-1 - j]."""
    T = taps.shape[0]
    n = x.shape[0] - (T - 1)
    y = x.new_zeros(n)
    for j in range(T):
        y = y + taps[j] * x[T - 1 - j:T - 1 - j + n]
    return y


def reference(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    return np.convolve(x, taps, mode="full")[:x.shape[0]].astype(x.dtype)


def default_size(n_devices: int) -> int:
    return 64 * 1024 * max(1, n_devices)            # Table 2: 64K SP samples


def make_umode(mesh):
    def fn(x, taps):
        return _fir_local(F.pad(x, (TAPS - 1, 0)), taps)
    return unified(fn, mesh, in_specs=(DEV, None), out_specs=DEV)


def make_dmode(mesh):
    n = mesh.size

    def local(xs, taps):
        T = taps[0].shape[0]
        # halo: last T-1 samples of the left neighbour (ring, shard 0 zero)
        halo = mesh.ppermute([x[-(T - 1):] for x in xs],
                             [(i, (i + 1) % n) for i in range(n)])
        # every shard masks its halo, shard 0's to zero (the reference's
        # jnp.where on the axis index: one program for every shard)
        halo = [h * float(i != 0) for i, h in enumerate(halo)]
        return [_fir_local(torch.cat([h, x]), t)
                for h, x, t in zip(halo, xs, taps)]
    return shard_map(local, mesh, in_specs=(DEV, None), out_specs=DEV)


def make_args(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, n).astype(np.float32),
            rng.normal(0, 1, TAPS).astype(np.float32))
