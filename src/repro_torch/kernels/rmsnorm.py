"""Fused RMSNorm: launcher of the CUDA kernel ``csrc/rmsnorm.cu``.

Port of the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
The kernel is bytes-bound: one block per row reads the row once and
writes it once (the design note is at the top of the source).  This
module checks what the kernel takes and raises on anything else; the
public wrapper with the launch counter is ``ops.rmsnorm``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_SIGNATURES = {
    "rmsnorm_fwd": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x (..., d) contiguous, w (d,), one CUDA device, one dtype (f32 or
    bf16) -> x * rsqrt(mean(x^2) + eps) * w in x's dtype."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm kernel takes x and w on one CUDA device, "
                         f"got {x.device} and {w.device}")
    if x.dtype not in build.DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if d == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm kernel takes x (..., d>0) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and w")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes < 2^31 rows, got {rows}")
    out = torch.empty_like(x)
    lib = build.load("rmsnorm", _SIGNATURES)
    err = lib.rmsnorm_fwd(build.DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                          out.data_ptr(), rows, d, eps,
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm launch")
    return out
