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
import torch.nn.functional as F

from . import bitonic as _bitonic
from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rms
from . import ssd as _ssd
from . import stencil as _stencil

__all__ = ["flash_attention", "rmsnorm", "ssd_chunk_kernel", "ssd_chunked",
           "stencil2d", "bitonic_stage", "launch_counts", "reset_launches",
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


def ssd_chunk_kernel(x, dt, cs, Bm, Cm):
    """Intra-chunk SSD.  x (R,H,Q,P); dt/cs (R,H,Q); Bm/Cm (R,H,Q,N) ->
    (y_diag (R,H,Q,P) f32, states (R,H,N,P) f32); on the card f32 inputs
    only (``kernels/ssd.py`` says what else the kernel takes)."""
    if _on_cpu(x, dt, cs, Bm, Cm):
        return ref.ssd_chunk_ref(x, dt, cs, Bm, Cm)
    out = _ssd.ssd_chunk(x, dt, cs, Bm, Cm)
    ssd_chunk_kernel.launches += 1
    return out


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 256, initial_state=None,
                return_state: bool = False):
    """Chunked SSD whose intra-chunk part runs on ``ssd_chunk_kernel``
    (port of ``repro/kernels/ops.py::ssd_pallas``, with the arguments of
    ``repro/models/ssm.py::ssd_scan``, which it replaces in the model).

    x (B,L,H,P); dt (B,L,H) after softplus; A (H,); Bm/Cm (B,L,G=1,N);
    initial_state (B,H,N,P) or None -> y (B,L,H,P) f32, and the final
    state (B,H,N,P) f32 with ``return_state``.  Any L: the sequence is
    padded to a multiple of Q = min(chunk, L) with dt = 0, which adds
    nothing to the states, and the padded rows of y are dropped."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G != 1:
        raise ValueError(f"ssd_chunked takes a single B/C group, got G={G}")
    Q = min(chunk, L)
    pad = (-L) % Q
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    C = (L + pad) // Q
    R = Bsz * C
    # (R=B*C, H, Q, .) views; B and C keep a head stride of 0
    xr = x.reshape(Bsz, C, Q, H, P).permute(0, 1, 3, 2, 4).reshape(R, H, Q, P)
    dtr = dt.reshape(Bsz, C, Q, H).permute(0, 1, 3, 2).reshape(R, H, Q)
    cs = torch.cumsum(dtr * A.float()[None, :, None], dim=-1)
    Br = Bm.reshape(R, 1, Q, N).expand(R, H, Q, N)
    Cr = Cm.reshape(R, 1, Q, N).expand(R, H, Q, N)
    y_diag, states = ssd_chunk_kernel(xr, dtr, cs, Br, Cr)

    # ---- inter-chunk recurrence (C steps of one (N,P) state per head) ----
    states = states.reshape(Bsz, C, H, N, P)
    chunk_decay = torch.exp(cs[..., -1]).reshape(Bsz, C, H)
    s = (initial_state.float() if initial_state is not None else
         torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device))
    s_in = []
    for c in range(C):
        s_in.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    s_in = torch.stack(s_in, dim=1)                        # (B,C,H,N,P)
    # ---- off-diagonal term: the state entering each chunk --------------
    y_off = torch.einsum("bcqn,bchnp,bchq->bchqp", Cm.reshape(Bsz, C, Q, N),
                         s_in, torch.exp(cs).reshape(Bsz, C, H, Q))
    y = (y_diag.reshape(Bsz, C, H, Q, P) + y_off).permute(0, 1, 3, 2, 4) \
        .reshape(Bsz, C * Q, H, P)[:, :L]
    return (y, s) if return_state else y


def stencil2d(img, kern):
    """img (H, W), kern (K, K) -> same-padded K x K stencil (H, W), zero
    outside the image, f32 sums, in img's dtype; on the card f32 or bf16
    img and K in {3, 5} (``kernels/stencil.py``)."""
    if _on_cpu(img, kern):
        return ref.stencil2d_ref(img, kern)
    out = _stencil.stencil2d(img, kern)
    stencil2d.launches += 1
    return out


def bitonic_stage(x, dist: int, size: int, block: int = 2048,
                  offset: int = 0):
    """One compare-exchange stage of x (L,): partner i ^ dist, ascending
    iff ((offset + i) & size) == 0, with the TPU API's checks: block is
    cut to L, dist < block, L % block == 0, block % (2 * dist) == 0, and
    dist a power of two (the pairing (i, i + dist) is i ^ dist only
    then).  ``offset`` is the global index of x[0] (a shard's start).  On
    the card f32 or int32 x (``kernels/bitonic.py``)."""
    L = x.shape[0]
    block = min(block, L)
    if not (1 <= dist < block and L % block == 0
            and block % (2 * dist) == 0 and dist & (dist - 1) == 0):
        raise ValueError(f"bitonic_stage takes a power-of-two dist < block "
                         f"<= L with L % block == 0 and block % (2 * dist) "
                         f"== 0, got dist={dist}, block={block}, L={L}")
    if _on_cpu(x):
        return ref.bitonic_stage_ref(x, dist, size, offset)
    out = _bitonic.bitonic_stage(x, dist, size, offset)
    bitonic_stage.launches += 1
    return out


flash_attention.launches = 0
rmsnorm.launches = 0
ssd_chunk_kernel.launches = 0
stencil2d.launches = 0
bitonic_stage.launches = 0
_WRAPPERS = (flash_attention, rmsnorm, ssd_chunk_kernel, stencil2d,
             bitonic_stage)


def launch_counts() -> typing.Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launches() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
