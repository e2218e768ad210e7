"""Causal GQA flash attention: launchers of the CUDA kernels
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

The forward ports the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  bf16 runs on the
tensor cores: one warpgroup per (64-row q tile, q-head, batch row),
Q K^T and P V as wgmma with f32 accumulation, K/V tiles brought in by TMA
through tensor maps over the tensors' own strides.  f32 keeps the
CUDA-core kernel (its 2e-5 gate rules out TF32).  Asked for, it also
stores each row's log-sum-exp, which the backward reads.  The backward
(no TPU counterpart: the JAX package differentiates plain jnp) takes
three launches in f32 and four in bf16, whose D, dK/dV and dQ launches
run every product as wgmma on tiles brought in by TMA (D = sum_j P_j
dP_j from the backward's own P, not from the bf16 output), the G
q-heads of a kv-head split over the blocks of a thread-block cluster
that sum their partial dK and dV through distributed shared memory; f32
keeps the CUDA-core kernels.  The design notes are at the top of the
sources.  This module checks what the kernels take and raises on
anything else; it never copies q, k or v.  The public wrappers with the
launch counters are ``ops.flash_attention`` and
``ops.flash_attention_bwd``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)        # template instantiations in the sources
TMA_ALIGN = 16                       # bytes: TMA's base and stride granule
TILE = 64                            # rows of the bf16 kernels' tiles
MAX_CLUSTER = 8                      # the portable thread-block cluster size

_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p], ctypes.c_int),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": (
        [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


def _check_qkv(q, k, v, causal: bool, what: str) -> None:
    """What both kernels take of q (B,Sq,H,hd) and k/v (B,Skv,K,hd)."""
    if q.device.type != "cuda" or not (k.device == v.device == q.device):
        raise ValueError(f"{what} kernel takes q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in build.DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{what} kernel takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what} kernel takes q (B,Sq,H,hd) and k = v "
                         f"(B,Skv,K,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"{what} kernel: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)} (H % K == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what} kernel takes hd in {HEAD_DIMS}, got {hd}")
    if causal and Sq != Skv:
        raise ValueError(f"causal {what} takes Sq == Skv, got {Sq} != {Skv}")
    if Skv == 0 or max(B, Sq, Skv, H) >= 2 ** 31 or B > 65535 or H > 65535:
        raise ValueError(f"{what} kernel: unsupported sizes B={B} Sq={Sq} "
                         f"Skv={Skv} H={H}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what} kernel takes q, k, v with a contiguous "
                         f"last dimension")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, with_lse: bool = False):
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd), H % K == 0, one CUDA device and
    dtype (f32 or bf16), hd in HEAD_DIMS, last dim contiguous; causal
    calls need Sq == Skv.  -> out (B,Sq,H,hd) in q's dtype; with
    ``with_lse``, (out, lse) with lse (B,H,Sq) f32, each row's
    log-sum-exp of its scaled scores (``ref.flash_attention_lse_ref``)."""
    _check_qkv(q, k, v, causal, "flash_attention")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        if (Sq + 63) // 64 > 65535:                 # q tiles on grid.z
            raise ValueError(f"bf16 flash_attention kernel takes Sq <= "
                             f"{65535 * 64}, got {Sq}")
        check_tma_operands(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]])
    lib = build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, H, K, Sq,
        Skv, hd, strides, 1.0 / math.sqrt(hd), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention launch")
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal)`` for
    the incoming gradient ``do`` of its output ``o``, from the forward's
    ``lse`` (B,H,Sq) f32: the arithmetic of
    ``ref.flash_attention_bwd_ref``, three launches (four in bf16).  q,
    k, v as the forward takes them (any (batch, seq, head) strides, last
    dim contiguous; bf16 also on TMA's grid, ``check_tma_operands``); o
    and do of q's shape and dtype; do is made contiguous (a copy only if
    it is not, or if it does not start on TMA's 16-byte grid).  dq, dk
    and dv come back contiguous, in q's dtype."""
    _check_qkv(q, k, v, causal, "flash_attention_bwd")
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd kernel takes {name} of q's "
                             f"shape {tuple(q.shape)} and dtype {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if o.stride(-1) != 1:
        raise ValueError("flash_attention_bwd kernel takes o with a "
                         "contiguous last dimension")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd kernel takes lse ({B}, {H}, "
                         f"{Sq}) f32 contiguous on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if q.numel() == 0:                  # no row: nothing reaches k or v
        return (torch.zeros(q.shape, dtype=q.dtype, device=q.device),
                torch.zeros(k.shape, dtype=k.dtype, device=k.device),
                torch.zeros(v.shape, dtype=v.dtype, device=v.device))
    do = do.contiguous()
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        if max(_tiles(Sq), _tiles(Skv)) > 65535:    # tiles on grid.z
            raise ValueError(f"bf16 flash_attention_bwd kernel takes Sq and "
                             f"Skv <= {65535 * TILE}, got {Sq}, {Skv}")
        if do.data_ptr() % TMA_ALIGN:
            do = do.clone()
        check_tma_operands(q, k, v, do)
        # (lse log2 e, D) per row, rows padded to whole tiles
        scratch = torch.empty((B, H, _tiles(Sq) * TILE, 2),
                              dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty((B, H, Sq), dtype=torch.float32,
                              device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    strides = (ctypes.c_longlong * 15)(*[
        s for t in (q, k, v, o, do) for s in t.stride()[:3]])
    lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
    err = lib.flash_attention_bwd(
        build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, H, K, Sq, Skv,
        hd, strides, 1.0 / math.sqrt(hd), int(causal),
        dkdv_cluster(H // K) if bf16 else 1,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention_bwd launch")
    return dq, dk, dv


def _tiles(n: int) -> int:
    return (n + TILE - 1) // TILE


def dkdv_cluster(G: int) -> int:
    """Blocks of one thread-block cluster that share a kv-head's G
    q-heads in the bf16 dK/dV launch: the largest divisor of G up to
    MAX_CLUSTER; each block loops over G / C of the heads."""
    return max(c for c in range(1, min(G, MAX_CLUSTER) + 1) if G % c == 0)


def check_tma_operands(*tensors: torch.Tensor) -> None:
    """The bf16 kernels read q, k, v (and, in the backward, do) through
    TMA tensor maps: each base pointer 16-byte aligned, and each (batch,
    seq, head) stride of a dimension longer than 1 positive and a
    multiple of 16 bytes (8 bf16 elements).  Raises ValueError
    otherwise."""
    for name, t in zip(("q", "k", "v", "do"), tensors):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"bf16 flash attention kernels take {name} "
                             f"16-byte aligned (TMA), got address "
                             f"{t.data_ptr():#x}")
        for size, stride in zip(t.shape[:3], t.stride()[:3]):
            if size > 1 and (stride <= 0
                             or stride * t.element_size() % TMA_ALIGN):
                raise ValueError(
                    f"bf16 flash attention kernels take {name} strides over "
                    f"(batch, seq, head) in positive multiples of 16 bytes "
                    f"(TMA), got {t.stride()}")
