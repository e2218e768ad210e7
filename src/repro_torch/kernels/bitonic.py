"""Bitonic compare-exchange stages: launchers of the CUDA kernels in
``csrc/bitonic.cu``, one stage a launch or a run of in-tile stages a
launch.

Port of the Pallas TPU kernel ``repro/kernels/bitonic.py::bitonic_stage``.
The kernel is bytes-bound: one thread per compare-exchange pair, the
pairs laid out so that loads and stores are coalesced (the design note is
at the top of the source).  The block kernel runs every stage with
dist below its tile in shared memory, one launch for a run of them.
This module checks what the kernels take and raises on anything else;
the public wrappers with the launch counters and the TPU API's block
checks are ``ops.bitonic_stage`` and ``ops.bitonic_block``.
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
    "bitonic_block_fwd": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
                          ctypes.c_int),
}
MAX_TILE = 2048                     # csrc/bitonic.cu's kMaxTile


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel takes x on a CUDA device, got "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes f32 or int32 x, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous x (L,), got "
                         f"shape {tuple(x.shape)}, strides {x.stride()}")


def bitonic_stage(x: torch.Tensor, dist: int, size: int, offset: int = 0
                  ) -> torch.Tensor:
    """x (L,) contiguous, f32 or int32, on a CUDA device; dist a power of
    two with 2 * dist dividing L; size and offset >= 0 -> one stage
    (partner i ^ dist, ascending iff ((offset + i) & size) == 0)."""
    _check_x(x, "bitonic_stage")
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


def bitonic_block(x: torch.Tensor, size: int, tile: int, offset: int = 0
                  ) -> torch.Tensor:
    """x (L,) contiguous, f32 or int32, on a CUDA device; tile a power of
    two in [2, 2048] dividing L and offset; size a power of two >= 2 ->
    the stages ``ref.bitonic_block_stages(size, tile)`` in one launch:
    every stage of the phases 2..size if size <= tile, else phase
    ``size``'s stages with dist tile/2..1."""
    _check_x(x, "bitonic_block")
    L = x.shape[0]
    if not (2 <= tile <= MAX_TILE and tile & (tile - 1) == 0
            and L % tile == 0 and L // tile < 2 ** 31):
        raise ValueError(f"bitonic_block kernel takes a power-of-two tile in "
                         f"[2, {MAX_TILE}] dividing L, got tile={tile}, L={L}")
    if size < 2 or size & (size - 1) or size >= 2 ** 62 or offset < 0 \
            or offset % tile or offset + L >= 2 ** 62:
        raise ValueError(f"bitonic_block kernel takes a power-of-two size >= "
                         f"2 and an offset >= 0 that is a multiple of the "
                         f"tile, both with offset + L < 2^62, got size={size}, "
                         f"offset={offset}, tile={tile}")
    log_size = size.bit_length() - 1
    out = torch.empty_like(x)
    lib = build.load("bitonic", _SIGNATURES)
    err = lib.bitonic_block_fwd(
        DTYPES[x.dtype], x.data_ptr(), out.data_ptr(), L,
        tile.bit_length() - 1, log_size if size > tile else 1, log_size,
        offset, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "bitonic_block launch")
    return out
