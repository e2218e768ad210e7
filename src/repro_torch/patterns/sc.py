"""Simple Convolution (2-D 3x3 stencil) — Adjacent Access pattern, 2-D
(port of ``repro/patterns/sc.py``).

Row-partitioned image; each shard needs one halo row from each
neighbour.  D-mode: two ``ppermute``s (up and down), then the stencil
kernel over each shard's (h+2, W) extended rows; rows 1..h of a
same-padded stencil over them are the reference's ``_stencil_padded``.
U-mode: the kernel over the whole image.  The reference's patterns run
plain jnp here; the port routes the hot spot through ``ops.stencil2d``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops, ref

from .mesh import DEV, shard_map
from .unified import local, unified

PATTERN = "adjacent"
K = 3


def reference(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    return ref.stencil2d_ref(torch.from_numpy(img),
                             torch.from_numpy(kern)).numpy()


def default_size(n_devices: int) -> int:
    return 1024 * max(1, int(np.sqrt(n_devices)) * 2)   # Table 2: 1024->2048


def make_umode(mesh):
    # the kernel takes the whole image
    return unified(local(ops.stencil2d, (None, None), None), mesh,
                   in_specs=(DEV, None), out_specs=DEV)


def make_dmode(mesh):
    n = mesh.size
    down = [(i, (i + 1) % n) for i in range(n)]
    up = [(i, (i - 1) % n) for i in range(n)]

    def local(imgs, kerns):
        top = mesh.ppermute([x[-1:] for x in imgs], down)
        bot = mesh.ppermute([x[:1] for x in imgs], up)
        # every shard masks its halos, the edge shards' to zero (the
        # reference's jnp.where on the axis index)
        top = [t * float(i != 0) for i, t in enumerate(top)]
        bot = [b * float(i != n - 1) for i, b in enumerate(bot)]
        return [ops.stencil2d(torch.cat([t, x, b]), k)[1:-1]
                for t, x, b, k in zip(top, imgs, bot, kerns)]
    return shard_map(local, mesh, in_specs=(DEV, None), out_specs=DEV)


def make_args(width: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (width, width)).astype(np.float32),
            rng.normal(0, 1, (K, K)).astype(np.float32))
