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

Its backward, ``ssd_chunk_bwd``, launches ``csrc/ssd_bwd.cu``: two
passes over the (64-row i-tile, j-tile) pairs at or below the diagonal,
every product 3xTF32 ``mma.sync``.  The first sums the column-side
gradients (dx, dB, ddt) and leaves each pair's dG in a workspace; the
second sums the row-side one, dC, from it.  No atomics (the design note
is at the top of that source).  Its public wrapper is
``ops.ssd_chunk_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_P, MAX_N = 128, 256              # accumulator and shared-memory limits
MAX_P_BWD, MAX_N_BWD = 64, 128       # the backward's register accumulators
BWD_TILE = 64                        # rows of the backward's i- and j-tiles

_SIGNATURES = {
    "ssd_chunk_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p], ctypes.c_int),
}
_BWD_SIGNATURES = {
    "ssd_chunk_bwd": (
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p], ctypes.c_int),
}


def _check(what: str, x, dt, cs, Bm, Cm, max_p: int, max_n: int):
    """Raise on forward inputs the kernel ``what`` does not take; returns
    (R, H, Q, P, N)."""
    tensors = (x, dt, cs, Bm, Cm)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"{what} takes x, dt, cs, Bm, Cm on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes f32 x, dt, cs, Bm, Cm, got "
                        f"{[t.dtype for t in tensors]}")
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4:
        raise ValueError(f"{what} takes x (R,H,Q,P), dt/cs (R,H,Q) and "
                         f"Bm/Cm (R,H,Q,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(Bm.shape)}")
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (R, H, Q) or cs.shape != dt.shape
            or Bm.shape != (R, H, Q, N) or Cm.shape != Bm.shape):
        raise ValueError(f"{what}: shapes do not match: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, cs "
                         f"{tuple(cs.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    if not (Q >= 1 and 1 <= P <= max_p and 1 <= N <= max_n
            and R <= 65535 and H <= 65535):
        raise ValueError(f"{what} takes Q >= 1, 1 <= P <= {max_p}, "
                         f"1 <= N <= {max_n}, R and H <= 65535; got R={R} "
                         f"H={H} Q={Q} P={P} N={N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError(f"{what} takes x, Bm, Cm with a contiguous "
                         f"last dimension")
    return R, H, Q, P, N


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor):
    """x (R,H,Q,P); dt/cs (R,H,Q); Bm/Cm (R,H,Q,N), all f32 on one CUDA
    device, any strides over (R,H,Q) (a head stride of 0 shares B/C
    across heads), the last dimension of x, Bm, Cm contiguous ->
    (y_diag (R,H,Q,P) f32, states (R,H,N,P) f32)."""
    tensors = (x, dt, cs, Bm, Cm)
    R, H, Q, P, N = _check("ssd kernel", *tensors, MAX_P, MAX_N)
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


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
                  dS: torch.Tensor):
    """Gradients of ``ssd_chunk`` for the incoming dy (R,H,Q,P) and dS
    (R,H,N,P): the forward's inputs as ``ssd_chunk`` takes them, with
    P <= 64 and N <= 128 -> (dx (R,H,Q,P), ddt (R,H,Q), dcs (R,H,Q),
    dB (R,H,Q,N), dC (R,H,Q,N)), all f32; dB and dC per head whatever
    B's and C's head stride.  dy and dS are made contiguous (a copy only
    if they are not)."""
    tensors = (x, dt, cs, Bm, Cm)
    R, H, Q, P, N = _check("ssd_chunk_bwd kernel", *tensors, MAX_P_BWD,
                           MAX_N_BWD)
    if dy.shape != (R, H, Q, P) or dS.shape != (R, H, N, P):
        raise ValueError(f"ssd_chunk_bwd kernel takes dy {(R, H, Q, P)} and "
                         f"dS {(R, H, N, P)}, got {tuple(dy.shape)} and "
                         f"{tuple(dS.shape)}")
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in (dy, dS)):
        raise TypeError(f"ssd_chunk_bwd kernel takes f32 dy and dS on "
                        f"{x.device}, got {dy.dtype} on {dy.device} and "
                        f"{dS.dtype} on {dS.device}")
    dy, dS = dy.contiguous(), dS.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((R, H, Q, P), **f32)
    ddt, dcs, wu = (torch.empty((R, H, Q), **f32) for _ in range(3))
    dB, dC = (torch.empty((R, H, Q, N), **f32) for _ in range(2))
    if R == 0 or H == 0:
        return dx, ddt, dcs, dB, dC
    # scratch: dG of each tile pair at or below the diagonal, and the sums
    # of Pm over each j-tile's rows
    tiles = -(-Q // BWD_TILE)
    gws = torch.empty((R * H * tiles * (tiles + 1) // 2, BWD_TILE,
                       BWD_TILE), **f32)
    pws = torch.empty((R, H, tiles, Q), **f32)
    strides = (ctypes.c_longlong * 15)(*[
        st for t in tensors for st in t.stride()[:3]])
    lib = build.load("ssd_bwd", _BWD_SIGNATURES)
    err = lib.ssd_chunk_bwd(
        *(t.data_ptr() for t in (x, dt, cs, Bm, Cm, dy, dS, dx, ddt, dcs,
                                 dB, dC, wu, gws, pws)),
        R, H, Q, P, N, strides,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd_chunk_bwd launch")
    return dx, ddt, dcs, dB, dC
