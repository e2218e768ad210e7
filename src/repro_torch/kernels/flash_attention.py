"""Causal GQA flash attention: launcher of the CUDA kernel
``csrc/flash_attention.cu``.

Port of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  bf16 runs on the
tensor cores: one warpgroup per (64-row q tile, q-head, batch row),
Q K^T and P V as wgmma with f32 accumulation, K/V tiles brought in by TMA
through tensor maps over the tensors' own strides.  f32 keeps the
CUDA-core kernel (its 2e-5 gate rules out TF32).  The design note is at
the top of the source.  This module checks what the kernel takes and
raises on anything else; it never copies an input.  The public wrapper
with the launch counter is ``ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)        # template instantiations in the source
TMA_ALIGN = 16                       # bytes: TMA's base and stride granule

_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p], ctypes.c_int),
}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd), H % K == 0, one CUDA device and
    dtype (f32 or bf16), hd in HEAD_DIMS, last dim contiguous; causal
    calls need Sq == Skv.  -> out (B,Sq,H,hd) in q's dtype."""
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError(f"flash_attention kernel takes q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in build.DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention kernel takes f32 or bf16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention kernel takes q (B,Sq,H,hd) and "
                         f"k = v (B,Skv,K,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} does "
                         f"not match k/v {tuple(k.shape)} (H % K == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS}, "
                         f"got {hd}")
    if causal and Sq != Skv:
        raise ValueError(f"causal flash_attention takes Sq == Skv, got "
                         f"{Sq} != {Skv}")
    if Skv == 0 or max(B, Sq, Skv, H) >= 2 ** 31 or B > 65535 or H > 65535:
        raise ValueError(f"flash_attention kernel: unsupported sizes "
                         f"B={B} Sq={Sq} Skv={Skv} H={H}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes q, k, v with a "
                         "contiguous last dimension")
    if q.dtype == torch.bfloat16:
        if (Sq + 63) // 64 > 65535:                 # q tiles on grid.z
            raise ValueError(f"bf16 flash_attention kernel takes Sq <= "
                             f"{65535 * 64}, got {Sq}")
        check_tma_operands(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, H, K, Sq, Skv, hd, strides,
        1.0 / math.sqrt(hd), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention launch")
    return out


def check_tma_operands(*tensors: torch.Tensor) -> None:
    """The bf16 kernel reads q, k, v through TMA tensor maps: each base
    pointer 16-byte aligned, and each (batch, seq, head) stride of a
    dimension longer than 1 positive and a multiple of 16 bytes (8 bf16
    elements).  Raises ValueError otherwise."""
    for name, t in zip("qkv", tensors):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"bf16 flash_attention kernel takes {name} "
                             f"16-byte aligned (TMA), got address "
                             f"{t.data_ptr():#x}")
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride <= 0
                             or stride * t.element_size() % TMA_ALIGN):
                raise ValueError(
                    f"bf16 flash_attention kernel takes {name} strides over "
                    f"(batch, seq, head) in positive multiples of 16 bytes "
                    f"(TMA), got {t.stride()}")
