"""One bitonic compare-exchange stage: launcher of the CUDA kernel
``csrc/bitonic.cu``.

Port of the Pallas TPU kernel ``repro/kernels/bitonic.py::bitonic_stage``.
The kernel is bytes-bound: one thread per compare-exchange pair, the
pairs laid out so that loads and stores are coalesced (the design note is
at the top of the source).  This module checks what the kernel takes and
raises on anything else; the public wrapper with the launch counter and
the TPU API's block checks is ``ops.bitonic_stage``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# dtype codes of csrc/common.cuh's enum DType that this kernel takes
DTYPES = {torch.float32: 0, torch.int32: 2}

_SIGNATURES = {
    "bitonic_stage_fwd": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p], ctypes.c_int),
}


def bitonic_stage(x: torch.Tensor, dist: int, size: int, offset: int = 0
                  ) -> torch.Tensor:
    """x (L,) contiguous, f32 or int32, on a CUDA device; dist a power of
    two with 2 * dist dividing L; size and offset >= 0 -> one stage
    (partner i ^ dist, ascending iff ((offset + i) & size) == 0)."""
    if x.device.type != "cuda":
        raise ValueError(f"bitonic_stage kernel takes x on a CUDA device, "
                         f"got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"bitonic_stage kernel takes f32 or int32 x, got "
                        f"{x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"bitonic_stage kernel takes a contiguous x (L,), "
                         f"got shape {tuple(x.shape)}, strides {x.stride()}")
    L = x.shape[0]
    if dist < 1 or dist & (dist - 1) or L % (2 * dist):
        raise ValueError(f"bitonic_stage kernel takes dist a power of two "
                         f"with 2 * dist dividing L, got dist={dist}, L={L}")
    if size < 0 or offset < 0 or size >= 2 ** 62 or offset + L >= 2 ** 62:
        raise ValueError(f"bitonic_stage kernel takes 0 <= size, offset + L "
                         f"< 2^62, got size={size}, offset={offset}")
    out = torch.empty_like(x)
    lib = build.load("bitonic", _SIGNATURES)
    err = lib.bitonic_stage_fwd(
        DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), L,
        dist.bit_length() - 1, size, offset,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "bitonic_stage launch")
    return out
