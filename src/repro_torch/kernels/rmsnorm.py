"""Fused RMSNorm: launcher of the CUDA kernel ``csrc/rmsnorm.cu``.

Port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
The kernel is launch-bound at the models' decode shapes: one block per
row reads the row once and writes it once, and two optional operands
fuse the op in front of the norm (the residual add, or Mamba2's gate)
into the same launch (the design note is at the top of the source).
The same source holds the backward of the plain and the residual form
(``rmsnorm_bwd``: two launches, a warp per row where the row fits its
registers, then the sum of the first launch's per-block dw partials) and
of the gated form (``gated_rmsnorm_bwd``: the same launches, the gate
recomputed from x and z).  This module checks what the kernels take and
raises on anything else; the public wrappers with the launch counters
are ``ops.rmsnorm``, ``ops.add_rmsnorm``, ``ops.gated_rmsnorm``,
``ops.rmsnorm_bwd``, ``ops.add_rmsnorm_bwd`` and
``ops.gated_rmsnorm_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SIGNATURES = {
    "rmsnorm_fwd": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "rmsnorm_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p],
                    ctypes.c_int),
    "gated_rmsnorm_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 8
                          + [ctypes.c_int] * 3
                          + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}
# the block-per-row backward's grid: at most this many blocks an SM (the
# warp-per-row kernel takes at most one)
BWD_BLOCKS_PER_SM = 2


def _launch(x, w, eps, r=None, z=None):
    """Checks, allocates and launches; returns (out, h or None)."""
    other = r if r is not None else z
    operands = [("x", x), ("w", w)] + (
        [] if other is None else [("r" if r is not None else "z", other)])
    if x.device.type != "cuda" or any(t.device != x.device
                                      for _, t in operands):
        raise ValueError(f"rmsnorm kernel takes its operands on one CUDA "
                         f"device, got {[(n, str(t.device)) for n, t in operands]}")
    if x.dtype not in build.DTYPES or any(t.dtype != x.dtype
                                          for _, t in operands):
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 operands of one "
                        f"dtype, got {[(n, t.dtype) for n, t in operands]}")
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm kernel takes x (..., d>0) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if other is not None and other.shape != x.shape:
        raise ValueError(f"rmsnorm kernel takes r or z of x's shape "
                         f"{tuple(x.shape)}, got {tuple(other.shape)}")
    if not all(t.is_contiguous() for _, t in operands):
        raise ValueError("rmsnorm kernel takes contiguous operands")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes < 2^31 rows, got {rows}")
    out = torch.empty_like(x)
    h = torch.empty_like(x) if r is not None else None
    lib = build.load("rmsnorm", _SIGNATURES)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = lib.rmsnorm_fwd(build.DTYPES[x.dtype], x.data_ptr(), ptr(r), ptr(z),
                          w.data_ptr(), out.data_ptr(), ptr(h), rows, d, eps,
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm launch")
    return out, h


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., d) contiguous, w (d,), one CUDA device, one dtype (f32 or
    bf16) -> x * rsqrt(mean(x^2) + eps) * w in x's dtype."""
    return _launch(x, w, eps)[0]


def add_rmsnorm(x: torch.Tensor, r: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6):
    """x, r (..., d) contiguous, w (d,) -> (h, out): h = x + r rounded to
    the dtype, out = rmsnorm(h, w)."""
    out, h = _launch(x, w, eps, r=r)
    return h, out


def gated_rmsnorm(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x, z (..., d) contiguous, w (d,) -> rmsnorm(x * silu(z), w), silu(z)
    and the product rounded to the dtype."""
    return _launch(x, w, eps, z=z)[0]


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6, dh: torch.Tensor = None):
    """Gradients (dx, dw) of ``rmsnorm(x, w)`` for the incoming dy; with
    dh (residual mode) x is the h that ``add_rmsnorm`` wrote and dx also
    carries dh, the gradient of h: dx = dh + the norm's input gradient,
    the gradient of both addends.  x (..., d) contiguous, w (d,), dy and
    dh of x's shape (made contiguous: a copy only if they are not), one
    CUDA device, one dtype (f32 or bf16); dx in x's dtype, dw in w's."""
    return _bwd("rmsnorm_bwd", x, w, dy, eps, dh=dh)


def gated_rmsnorm_bwd(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-6):
    """Gradients (dx, dz, dw) of ``gated_rmsnorm(x, z, w)`` for the
    incoming dy, each rounded once to its input's dtype.  x, z (..., d)
    contiguous, w (d,), dy of x's shape (made contiguous: a copy only if
    it is not), one CUDA device, one dtype (f32 or bf16)."""
    return _bwd("gated_rmsnorm_bwd", x, w, dy, eps, z=z)


def _bwd(what, x, w, dy, eps, dh=None, z=None):
    """Checks, allocates and launches the backward ``what`` (two launches:
    the rows, then the sum of the per-block dw partials); returns (dx, dw),
    or (dx, dz, dw) with the gate z."""
    extra = [(n, t) for n, t in (("dh", dh), ("z", z)) if t is not None]
    operands = [("x", x), ("w", w), ("dy", dy)] + extra
    if x.device.type != "cuda" or any(t.device != x.device
                                      for _, t in operands):
        raise ValueError(f"{what} kernel takes its operands on one CUDA "
                         f"device, got {[(n, str(t.device)) for n, t in operands]}")
    if x.dtype not in build.DTYPES or any(t.dtype != x.dtype
                                          for _, t in operands):
        raise TypeError(f"{what} kernel takes f32 or bf16 operands of "
                        f"one dtype, got {[(n, t.dtype) for n, t in operands]}")
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"{what} kernel takes x (..., d>0) and w (d,), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if any(t.shape != x.shape for n, t in operands if n != "w"):
        raise ValueError(f"{what} kernel takes dy, dh and z of x's shape "
                         f"{tuple(x.shape)}, got "
                         f"{[(n, tuple(t.shape)) for n, t in operands]}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (z is None or z.is_contiguous())):
        raise ValueError(f"{what} kernel takes contiguous x, w (and z)")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"{what} kernel takes < 2^31 rows, got {rows}")
    dx = torch.empty_like(x)
    dz = None if z is None else torch.empty_like(z)
    grads = (dx,) if z is None else (dx, dz)
    if rows == 0:
        return (*grads, torch.zeros_like(w))
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nblk = min(rows, BWD_BLOCKS_PER_SM * sms)
    dw = torch.empty_like(w)
    partial = torch.empty((nblk, d), dtype=torch.float32, device=x.device)
    lib = build.load("rmsnorm", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if z is None:
        err = lib.rmsnorm_bwd(build.DTYPES[x.dtype], x.data_ptr(),
                              w.data_ptr(), dy.data_ptr(),
                              None if dh is None else dh.data_ptr(),
                              dx.data_ptr(), dw.data_ptr(),
                              partial.data_ptr(), rows, d, nblk, eps, stream)
    else:
        err = lib.gated_rmsnorm_bwd(build.DTYPES[x.dtype], x.data_ptr(),
                                    z.data_ptr(), w.data_ptr(), dy.data_ptr(),
                                    dx.data_ptr(), dz.data_ptr(),
                                    dw.data_ptr(), partial.data_ptr(), rows,
                                    d, nblk, eps, stream)
    build.check(lib, err, f"{what} launch")
    return (*grads, dw)
