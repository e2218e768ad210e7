"""Matrix Transpose — Scatter pattern (port of ``repro/patterns/mt.py``).

Row-partitioned matrix; the transpose scatters every shard's blocks to
every other shard.  D-mode is one explicit ``all_to_all`` of (M, Nl, Nl)
blocks and a local block transpose; U-mode is ``x.T`` made contiguous on
one device, as the reference's row-sharded output materialises it.
"""
from __future__ import annotations

import numpy as np

from .mesh import DEV, shard_map
from .unified import unified

PATTERN = "scatter"


def reference(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.T)


def default_size(n_devices: int) -> int:
    return 2048 * max(1, int(np.sqrt(n_devices)) * 2)  # Table 2: 2048->4096


def make_umode(mesh):
    return unified(lambda x: x.T.contiguous(), mesh, in_specs=(DEV,),
                   out_specs=DEV)


def make_dmode(mesh):
    m = mesh.size

    def local(xs):                                 # xs[q] (Nl, N) rows
        Nl = xs[0].shape[0]
        blocks = [x.reshape(Nl, m, Nl).permute(1, 0, 2) for x in xs]
        recv = mesh.all_to_all(blocks, split_axis=0, concat_axis=0)
        # recv[q][p] = block B_pq owned by sender p; Y_q column block p =
        # B_pq^T
        return [r.permute(2, 0, 1).reshape(Nl, m * Nl) for r in recv]
    return shard_map(local, mesh, in_specs=(DEV,), out_specs=DEV)


def make_args(width: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (width, width)).astype(np.float32),)
