"""Mamba2 SSD intra-chunk kernel: launcher of the CUDA kernel
``csrc/ssd.cu``.

Port of the Pallas TPU kernel ``repro/kernels/ssd.py::ssd_chunk_kernel``.
One block per (64-row i-tile, head, chunk) walks 64-row j-tiles of B
and x up to the diagonal, staged by cp.async; the chunk states are
blocks of their own in the same grid.  All three products (C B^T,
att @ x, (B w)^T @ x) run on the tensor cores as 3xTF32 ``mma.sync``
(each f32 operand split into two TF32 parts, three products summed in
f32), which keeps the f32 kernel's accuracy; the design note is at the
top of the source.  A short chunk (any Q >= 1) is masked in the kernel,
not padded here.  This module checks what the kernel takes and raises on
anything else; the public wrapper with the launch counter is
``ops.ssd_chunk_kernel``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_P, MAX_N = 128, 256              # accumulator and shared-memory limits

_SIGNATURES = {
    "ssd_chunk_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p], ctypes.c_int),
}


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """x (R,H,Q,P); dt/cs (R,H,Q); Bm/Cm (R,H,Q,N), all f32 on one CUDA
    device, any strides over (R,H,Q) (a head stride of 0 shares B/C
    across heads), the last dimension of x, Bm, Cm contiguous ->
    (y_diag (R,H,Q,P) f32, states (R,H,N,P) f32)."""
    tensors = (x, dt, cs, Bm, Cm)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd kernel takes x, dt, cs, Bm, Cm on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd kernel takes f32 x, dt, cs, Bm, Cm, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4:
        raise ValueError(f"ssd kernel takes x (R,H,Q,P), dt/cs (R,H,Q) and "
                         f"Bm/Cm (R,H,Q,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}")
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (R, H, Q) or cs.shape != dt.shape
            or Bm.shape != (R, H, Q, N) or Cm.shape != Bm.shape):
        raise ValueError(f"ssd kernel: shapes do not match: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, cs "
                         f"{tuple(cs.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    if not (Q >= 1 and 1 <= P <= MAX_P and 1 <= N <= MAX_N
            and R <= 65535 and H <= 65535):
        raise ValueError(f"ssd kernel takes Q >= 1, 1 <= P <= {MAX_P}, "
                         f"1 <= N <= {MAX_N}, R and H <= 65535; got R={R} "
                         f"H={H} Q={Q} P={P} N={N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd kernel takes x, Bm, Cm with a contiguous "
                         "last dimension")
    y = torch.empty((R, H, Q, P), dtype=torch.float32, device=x.device)
    s = torch.empty((R, H, N, P), dtype=torch.float32, device=x.device)
    if R == 0 or H == 0:
        return y, s
    strides = (ctypes.c_longlong * 15)(*[
        st for t in tensors for st in t.stride()[:3]])
    lib = build.load("ssd", _SIGNATURES)
    err = lib.ssd_chunk_fwd(
        x.data_ptr(), dt.data_ptr(), cs.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), s.data_ptr(), R, H, Q, P, N, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd launch")
    return y, s
