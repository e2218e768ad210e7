"""KMeans (one assignment + partial-sum iteration) — Partitioned Data
(port of ``repro/patterns/km.py``).

Points are partitioned; every device computes distances and assignments
for its slice and local per-cluster partial sums.  The centroid update
is one small ``psum`` of the (K,F) and (K,) partials; devices never
exchange points.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import DEV, shard_map
from .unified import unified

PATTERN = "partitioned"
FEATURES = 32
CLUSTERS = 16


def _assign_and_sum(pts, cent):
    """pts (n,F), cent (K,F) -> (sums (K,F), counts (K,), assign (n,))."""
    d2 = ((pts * pts).sum(-1, keepdim=True) - 2.0 * pts @ cent.T
          + (cent * cent).sum(-1)[None])
    a = torch.argmin(d2, dim=-1)
    onehot = F.one_hot(a, cent.shape[0]).to(pts.dtype)
    return onehot.T @ pts, onehot.sum(0), a.to(torch.int32)


def _centroids(sums, counts):
    return sums / torch.clamp(counts[:, None], min=1)


def reference(points: np.ndarray, centroids: np.ndarray):
    d2 = ((points[:, None, :] - centroids[None]) ** 2).sum(-1)
    a = d2.argmin(-1)
    sums = np.zeros_like(centroids)
    counts = np.zeros(centroids.shape[0])
    for k in range(centroids.shape[0]):
        sel = points[a == k]
        sums[k] = sel.sum(0) if len(sel) else 0
        counts[k] = len(sel)
    new = sums / np.maximum(counts[:, None], 1)
    return new.astype(points.dtype)


def default_size(n_devices: int) -> int:
    return 32 * 1024 * max(1, n_devices)            # Table 2: 32K pts x devs


def make_umode(mesh):
    def fn(pts, cent):
        sums, counts, _ = _assign_and_sum(pts, cent)
        return _centroids(sums, counts)
    return unified(fn, mesh, in_specs=(DEV, None), out_specs=None)


def make_dmode(mesh):
    def local(pts, cents):
        parts = [_assign_and_sum(p, c) for p, c in zip(pts, cents)]
        # one all-reduce of both partials, as XLA combines the reference's
        # two psums
        sums, counts = mesh.psum([s for s, _, _ in parts],
                                 [c for _, c, _ in parts])
        return [_centroids(s, c) for s, c in zip(sums, counts)]
    return shard_map(local, mesh, in_specs=(DEV, None), out_specs=None)


def make_args(n_points: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 1, (n_points, FEATURES)).astype(np.float32)
    cent = rng.normal(0, 1, (CLUSTERS, FEATURES)).astype(np.float32)
    return pts, cent
