"""Gradient Descent (data-parallel linear regression) — Gather pattern
(port of ``repro/patterns/gd.py``).

Each device computes the gradient over its mini-batch shard; the
gradients are summed across the mesh, the gather every data-parallel
trainer performs each step.  STEPS steps run in one program, so D-mode
makes STEPS ``psum``s (the reference's ``scan`` is a loop here).
"""
from __future__ import annotations

import numpy as np

from .mesh import DEV, shard_map
from .unified import unified

PATTERN = "gather"
FEATURES = 256
STEPS = 8
LR = 0.05


def reference(X: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    w = w.copy().astype(np.float64)
    for _ in range(STEPS):
        g = X.T.astype(np.float64) @ (X.astype(np.float64) @ w
                                      - y.astype(np.float64)) / X.shape[0]
        w = w - LR * g
    return w.astype(X.dtype)


def default_size(n_devices: int) -> int:
    return 64 * 1024 * max(1, n_devices)   # Table 2: 256K/1M params scaled


def make_umode(mesh):
    def fn(X, y, w):
        for _ in range(STEPS):
            g = X.T @ (X @ w - y) / X.shape[0]
            w = w - LR * g
        return w
    return unified(fn, mesh, in_specs=(DEV, None, None), out_specs=None)


def make_dmode(mesh):
    def local(Xs, ys, ws):
        n = Xs[0].shape[0] * mesh.size
        for _ in range(STEPS):
            g = mesh.psum([X.T @ (X @ w - y) / n
                           for X, y, w in zip(Xs, ys, ws)])   # THE gather
            ws = [w - LR * gi for w, gi in zip(ws, g)]
        return ws
    return shard_map(local, mesh, in_specs=(DEV, DEV, None), out_specs=None)


def make_args(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, FEATURES)).astype(np.float32)
    w_true = rng.normal(0, 1, FEATURES).astype(np.float32)
    y = X @ w_true + rng.normal(0, 0.01, n).astype(np.float32)
    w0 = np.zeros(FEATURES, np.float32)
    return X, y, w0
