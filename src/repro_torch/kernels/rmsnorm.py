"""Fused RMSNorm: launcher of the CUDA kernel ``csrc/rmsnorm.cu``.

Port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
The kernel is launch-bound at the models' decode shapes: one block per
row reads the row once and writes it once, and two optional operands
fuse the op in front of the norm (the residual add, or Mamba2's gate)
into the same launch (the design note is at the top of the source).
This module checks what the kernel takes and raises on anything else;
the public wrappers with the launch counters are ``ops.rmsnorm``,
``ops.add_rmsnorm`` and ``ops.gated_rmsnorm``.
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
}


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
