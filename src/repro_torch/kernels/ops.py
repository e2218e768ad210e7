"""Public wrappers of the hand-written kernels (port of
``repro/kernels/ops.py``).

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(``ref.py``), which is how the CPU tests reach it.  Given CUDA tensors
it launches the CUDA kernel or raises; it never falls back.  Each
wrapper carries a plain integer ``launches`` that counts its kernel
launches, so a run can show that its path went through the kernels.
"""
from __future__ import annotations

import typing

import torch

from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rms

__all__ = ["flash_attention", "rmsnorm", "launch_counts", "reset_launches",
           "ref"]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {devices}")
    return devices.pop().type == "cpu"


def flash_attention(q, k, v, causal: bool = True):
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd); H % K == 0 -> out (B,Sq,H,hd).
    Causal calls need Sq == Skv, on every device (the kernel's top-left
    mask equals the plain version's bottom-right one only there)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash_attention takes Sq == Skv, got "
                         f"{q.shape[1]} != {k.shape[1]}")
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    out = _fa.flash_attention(q, k, v, causal=causal)
    flash_attention.launches += 1
    return out


def rmsnorm(x, w, eps: float = 1e-6):
    """x (..., d), w (d,) -> x * rsqrt(mean(x^2) + eps) * w, fused."""
    if _on_cpu(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    out = _rms.rmsnorm(x, w, eps)
    rmsnorm.launches += 1
    return out


flash_attention.launches = 0
rmsnorm.launches = 0
_WRAPPERS = (flash_attention, rmsnorm)


def launch_counts() -> typing.Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launches() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
