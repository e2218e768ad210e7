"""2-D K x K stencil: launcher of the CUDA kernel ``csrc/stencil.cu``.

Port of the Pallas TPU kernel ``repro/kernels/stencil.py::stencil2d``.
The kernel is bytes-bound: one block per 32 x 64 output tile stages the
tile and its halo in shared memory (the design note is at the top of the
source).  Any H and W: the ragged edges are masked in the kernel, so the
TPU wrapper's ``H % block_rows == 0`` does not carry over.  This module
checks what the kernel takes and raises on anything else; the public
wrapper with the launch counter is ``ops.stencil2d``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KS = (3, 5)                          # kernel widths the source is built for
MAX_ROW_TILES = 65535                # gridDim.y: 32 rows per tile

_SIGNATURES = {
    "stencil2d_fwd": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


def stencil2d(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """img (H, W) contiguous, f32 or bf16; kern (K, K), K in {3, 5}, f32
    or bf16, on img's CUDA device -> the same-padded stencil (H, W) in
    img's dtype (f32 sums)."""
    if img.device.type != "cuda" or kern.device != img.device:
        raise ValueError(f"stencil2d kernel takes img and kern on one CUDA "
                         f"device, got {img.device} and {kern.device}")
    if img.dtype not in build.DTYPES or kern.dtype not in build.DTYPES:
        raise TypeError(f"stencil2d kernel takes f32 or bf16 img and kern, "
                        f"got {img.dtype} and {kern.dtype}")
    if img.dim() != 2 or kern.dim() != 2 or kern.shape[0] != kern.shape[1] \
            or kern.shape[0] not in KS:
        raise ValueError(f"stencil2d kernel takes img (H, W) and kern (K, K) "
                         f"with K in {KS}, got {tuple(img.shape)} and "
                         f"{tuple(kern.shape)}")
    if not img.is_contiguous():
        raise ValueError("stencil2d kernel takes a contiguous img")
    H, W = img.shape
    if -(-H // 32) > MAX_ROW_TILES or W >= 2 ** 31:
        raise ValueError(f"stencil2d kernel takes H <= {32 * MAX_ROW_TILES} "
                         f"and W < 2^31, got {H} x {W}")
    out = torch.empty_like(img)
    kf = kern.float().contiguous()
    lib = build.load("stencil", _SIGNATURES)
    err = lib.stencil2d_fwd(build.DTYPES[img.dtype], img.data_ptr(),
                            kf.data_ptr(), out.data_ptr(), H, W,
                            kern.shape[0],
                            torch.cuda.current_stream(img.device).cuda_stream)
    build.check(lib, err, "stencil2d launch")
    return out
