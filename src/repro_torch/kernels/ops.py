"""Public wrappers of the hand-written kernels (port of
``repro/kernels/ops.py``).

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(``ref.py``), which is how the CPU tests reach it.  Given CUDA tensors
it launches the CUDA kernel or raises; it never falls back.  Each
wrapper carries a plain integer ``launches`` that counts its kernel
launches, so a run can show that its path went through the kernels.

Outputs filled through ctypes carry no ``grad_fn``, so gradients on the
card go through ``torch.autograd.Function``s whose backward is a kernel
too: ``flash_attention``, ``rmsnorm``, ``add_rmsnorm``, ``gated_rmsnorm``
and ``ssd_chunk_kernel`` apply theirs (``_FlashAttention``, ``_RMSNorm``,
``_AddRMSNorm``, ``_GatedRMSNorm``, ``_SSDChunk``) when grad mode is on
and an input requires grad, and otherwise launch the forward alone, with
nothing saved.  Their backward kernels are not themselves
differentiable: a double backward raises.  The kernels without a
backward (stencil, bitonic) refuse such inputs with ``check_no_grad``
(``KernelBackwardMissing``) rather than cut the graph without a word.
On the CPU the plain versions differentiate as usual.

Given ``meta`` tensors inside ``repro_torch.core.hlo.analyze``, a wrapper
(and each Function's backward) launches nothing: it records the kernel's
operations and bytes (``cost.py``) as one trace op named after it and
returns empty meta outputs, so that a trace describes the kernel path.
Meta tensors outside ``analyze`` raise.
"""
from __future__ import annotations

import typing

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.core import hlo

from . import bitonic as _bitonic
from . import cost
from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rms
from . import ssd as _ssd
from . import stencil as _stencil

__all__ = ["flash_attention", "flash_attention_bwd", "rmsnorm",
           "rmsnorm_bwd", "add_rmsnorm", "add_rmsnorm_bwd", "gated_rmsnorm",
           "gated_rmsnorm_bwd", "ssd_chunk_kernel", "ssd_chunk_bwd",
           "ssd_chunked", "stencil2d", "bitonic_stage", "bitonic_block",
           "check_no_grad", "KernelBackwardMissing", "launch_counts",
           "reset_launches", "ref"]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """The route of a call: True for the plain version (CPU tensors);
    False for the kernel, launched on CUDA tensors or, on ``meta`` inside
    ``core.hlo.analyze``, traced (``_kernel``).  Meta tensors outside
    ``analyze``, and CUDA tensors inside it, raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on more than one device: {devices}")
    kind = devices.pop().type
    if kind == "meta" and not hlo.tracing():
        raise RuntimeError("a kernel wrapper got meta tensors outside "
                           "repro_torch.core.hlo.analyze: nothing to launch")
    if kind == "cuda" and hlo.tracing():
        raise RuntimeError("analyze() traces the kernel path on meta "
                           "tensors; a CUDA kernel's launch is not traced")
    return kind == "cpu"


def _kernel(wrapper, launch, meta, *args, **kwargs):
    """``launch(*args, **kwargs)``, counted in ``wrapper.launches``.  On
    the meta device (inside ``analyze``) nothing launches and nothing is
    counted: ``meta(*args, **kwargs)`` gives the kernel's (operations,
    bytes, outputs), recorded as one ``TraceOp`` named after the wrapper,
    and the outputs, empty meta tensors of the kernel's shapes and
    dtypes, are returned.  In a sharded trace the op belongs to its
    tensor arguments' shard."""
    if args[0].device.type == "meta":
        ops, nbytes, out = meta(*args, **kwargs)
        hlo.record(wrapper.__name__, ops, nbytes, inputs=args)
        return out
    out = launch(*args, **kwargs)
    wrapper.launches += 1
    return out


def _fa_meta(q, k, v, causal=True, with_lse=False):
    out = torch.empty_like(q)
    lse = q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32)
    return (*cost.flash_attention(q, k, causal, with_lse),
            (out, lse) if with_lse else out)


def _fa_bwd_meta(q, k, v, o, lse, do, causal=True):
    return (*cost.flash_attention_bwd(q, k, lse, causal),
            (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)))


def _norm_meta(x, w, eps):
    return (*cost.rmsnorm(x, w), torch.empty_like(x))


def _add_norm_meta(x, r, w, eps):
    return (*cost.add_rmsnorm(x, w), (torch.empty_like(x),
                                      torch.empty_like(x)))


def _gated_norm_meta(x, z, w, eps):
    return (*cost.gated_rmsnorm(x, w), torch.empty_like(x))


def _norm_bwd_meta(x, w, dy, eps, dh=None):
    return (*cost.rmsnorm_bwd(x, w, residual=dh is not None),
            (torch.empty_like(x), torch.empty_like(w)))


def _gated_norm_bwd_meta(x, z, w, dy, eps):
    return (*cost.gated_rmsnorm_bwd(x, w),
            (torch.empty_like(x), torch.empty_like(z), torch.empty_like(w)))


def _ssd_meta(x, dt, cs, Bm, Cm):
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    return (*cost.ssd_chunk(x, Bm),
            (x.new_empty((R, H, Q, P), dtype=torch.float32),
             x.new_empty((R, H, N, P), dtype=torch.float32)))


def _ssd_bwd_meta(x, dt, cs, Bm, Cm, dy, dS):
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    f32 = (lambda *shape: x.new_empty(shape, dtype=torch.float32))
    return (*cost.ssd_chunk_bwd(x, Bm),
            (f32(R, H, Q, P), f32(R, H, Q), f32(R, H, Q), f32(R, H, Q, N),
             f32(R, H, Q, N)))


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class KernelBackwardMissing(RuntimeError):
    """A kernel without a backward was asked for one: a fault of the
    program, which raises the same way every time, not of a node (the
    training loop re-raises it rather than restore and replay)."""


def check_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``KernelBackwardMissing`` if autograd would need a backward
    of kernel ``name``, which has none: grad mode is on and an input
    requires grad.  The wrappers of the kernels without a backward call
    it before they launch on the card; under ``torch.no_grad()`` it
    passes."""
    if _needs_grad(*tensors):
        raise KernelBackwardMissing(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            f"grad.  No model trains through it; differentiate its plain "
            f"version (CPU tensors, or ref.py), or call it under "
            f"torch.no_grad()")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with the log-sum-exp stored; backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _kernel(flash_attention, _fa.flash_attention, _fa_meta,
                           q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do, ctx.causal),
                None)


def flash_attention(q, k, v, causal: bool = True):
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd); H % K == 0 -> out (B,Sq,H,hd).
    Causal calls need Sq == Skv, on every device (the kernel's top-left
    mask equals the plain version's bottom-right one only there).  On the
    card, with grad, the backward runs ``flash_attention_bwd``."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash_attention takes Sq == Skv, got "
                         f"{q.shape[1]} != {k.shape[1]}")
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _kernel(flash_attention, _fa.flash_attention, _fa_meta, q, k, v,
                   causal=causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention`` from its output o,
    its log-sum-exp lse (B,H,Sq) f32 and the incoming do, in the inputs'
    dtypes (``ref.flash_attention_bwd_ref``; three launches on the card,
    four in bf16, counted as one call; bf16 on the tensor cores, whose q,
    k, v must lie on TMA's grid as the forward's do)."""
    if _on_cpu(q, k, v, o, lse, do):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    return _kernel(flash_attention_bwd, _fa.flash_attention_bwd, _fa_bwd_meta,
                   q, k, v, o, lse, do, causal=causal)


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, eps):
        out = _kernel(rmsnorm, _rms.rmsnorm, _norm_meta, x, w, eps)
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return (*rmsnorm_bwd(x, w, dy, ctx.eps), None)


class _AddRMSNorm(torch.autograd.Function):
    """(h, out) = (x + r, rmsnorm(x + r)); x and r get the same gradient.
    Either incoming gradient may be None (a model that reads only one of
    the two outputs)."""

    @staticmethod
    def forward(ctx, x, r, w, eps):
        h, out = _kernel(add_rmsnorm, _rms.add_rmsnorm, _add_norm_meta,
                         x, r, w, eps)
        ctx.save_for_backward(h, w)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return h, out

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dout):
        if dout is None:                       # the norm's output unread
            return dh, dh, None, None
        h, w = ctx.saved_tensors
        dx, dw = add_rmsnorm_bwd(h, w, dout, dh, ctx.eps)
        return dx, dx, dw, None


def rmsnorm(x, w, eps: float = 1e-6):
    """x (..., d), w (d,) -> x * rsqrt(mean(x^2) + eps) * w, fused.  On
    the card, with grad, the backward runs ``rmsnorm_bwd``."""
    if _on_cpu(x, w):
        return ref.rmsnorm_ref(x, w, eps)
    if _needs_grad(x, w):
        return _RMSNorm.apply(x, w, eps)
    return _kernel(rmsnorm, _rms.rmsnorm, _norm_meta, x, w, eps)


def rmsnorm_bwd(x, w, dy, eps: float = 1e-6):
    """Gradients (dx, dw) of ``rmsnorm(x, w)`` for the incoming dy
    (``ref.rmsnorm_bwd_ref``; two launches on the card, counted as one
    call)."""
    if _on_cpu(x, w, dy):
        return ref.rmsnorm_bwd_ref(x, w, dy, eps)
    return _kernel(rmsnorm_bwd, _rms.rmsnorm_bwd, _norm_bwd_meta, x, w, dy, eps)


def add_rmsnorm(x, r, w, eps: float = 1e-6):
    """x, r (..., d), w (d,) -> (h, out): the residual add h = x + r and
    out = rmsnorm(h, w), in one launch on the card.  On the card, with
    grad, the backward runs ``add_rmsnorm_bwd``."""
    if _on_cpu(x, r, w):
        return ref.add_rmsnorm_ref(x, r, w, eps)
    if _needs_grad(x, r, w):
        return _AddRMSNorm.apply(x, r, w, eps)
    return _kernel(add_rmsnorm, _rms.add_rmsnorm, _add_norm_meta, x, r, w, eps)


def add_rmsnorm_bwd(h, w, dout, dh=None, eps: float = 1e-6):
    """Gradients (dx, dw) of ``add_rmsnorm``'s (h, out) from the h it
    wrote and the incoming dout and dh (None: zero); dx is the gradient of
    both addends (``ref.add_rmsnorm_bwd_ref``; the rmsnorm backward
    kernel's residual mode on the card, two launches counted as one
    call)."""
    extra = () if dh is None else (dh,)
    if _on_cpu(h, w, dout, *extra):
        return ref.add_rmsnorm_bwd_ref(h, w, dout, dh, eps)
    return _kernel(add_rmsnorm_bwd, _rms.rmsnorm_bwd, _norm_bwd_meta,
                   h, w, dout, eps, dh=dh)


class _GatedRMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, z, w, eps):
        out = _kernel(gated_rmsnorm, _rms.gated_rmsnorm, _gated_norm_meta,
                      x, z, w, eps)
        ctx.save_for_backward(x, z, w)
        ctx.eps = eps
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, z, w = ctx.saved_tensors
        return (*gated_rmsnorm_bwd(x, z, w, dy, ctx.eps), None)


def gated_rmsnorm(x, z, w, eps: float = 1e-6):
    """x, z (..., d), w (d,) -> rmsnorm(x * silu(z), w) (Mamba2's gated
    norm), in one launch on the card.  On the card, with grad, the
    backward runs ``gated_rmsnorm_bwd``."""
    if _on_cpu(x, z, w):
        return ref.gated_rmsnorm_ref(x, z, w, eps)
    if _needs_grad(x, z, w):
        return _GatedRMSNorm.apply(x, z, w, eps)
    return _kernel(gated_rmsnorm, _rms.gated_rmsnorm, _gated_norm_meta,
                   x, z, w, eps)


def gated_rmsnorm_bwd(x, z, w, dy, eps: float = 1e-6):
    """Gradients (dx, dz, dw) of ``gated_rmsnorm(x, z, w)`` for the
    incoming dy (``ref.gated_rmsnorm_bwd_ref``; two launches on the card,
    counted as one call)."""
    if _on_cpu(x, z, w, dy):
        return ref.gated_rmsnorm_bwd_ref(x, z, w, dy, eps)
    return _kernel(gated_rmsnorm_bwd, _rms.gated_rmsnorm_bwd,
                   _gated_norm_bwd_meta, x, z, w, dy, eps)


class _SSDChunk(torch.autograd.Function):
    """The chunk's (y_diag, states); the backward takes both incoming
    gradients (a zero one for an unread output)."""

    @staticmethod
    def forward(ctx, x, dt, cs, Bm, Cm):
        out = _kernel(ssd_chunk_kernel, _ssd.ssd_chunk, _ssd_meta,
                      x, dt, cs, Bm, Cm)
        ctx.save_for_backward(x, dt, cs, Bm, Cm)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dS):
        return ssd_chunk_bwd(*ctx.saved_tensors, dy, dS)


def ssd_chunk_kernel(x, dt, cs, Bm, Cm):
    """Intra-chunk SSD.  x (R,H,Q,P); dt/cs (R,H,Q); Bm/Cm (R,H,Q,N) ->
    (y_diag (R,H,Q,P) f32, states (R,H,N,P) f32); on the card f32 inputs
    only (``kernels/ssd.py`` says what else the kernel takes).  On the
    card, with grad, the backward runs ``ssd_chunk_bwd``."""
    if _on_cpu(x, dt, cs, Bm, Cm):
        return ref.ssd_chunk_ref(x, dt, cs, Bm, Cm)
    if _needs_grad(x, dt, cs, Bm, Cm):
        return _SSDChunk.apply(x, dt, cs, Bm, Cm)
    return _kernel(ssd_chunk_kernel, _ssd.ssd_chunk, _ssd_meta,
                   x, dt, cs, Bm, Cm)


def ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy, dS):
    """Gradients (dx, ddt, dcs, dB, dC) of ``ssd_chunk_kernel`` for the
    incoming dy (R,H,Q,P) and dS (R,H,N,P), f32, dB and dC per head
    (R,H,Q,N) (``ref.ssd_chunk_bwd_ref``; two launches on the card,
    counted as one call; P <= 64 and N <= 128 there)."""
    if _on_cpu(x, dt, cs, Bm, Cm, dy, dS):
        return ref.ssd_chunk_bwd_ref(x, dt, cs, Bm, Cm, dy, dS)
    return _kernel(ssd_chunk_bwd, _ssd.ssd_chunk_bwd, _ssd_bwd_meta,
                   x, dt, cs, Bm, Cm, dy, dS)


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
    check_no_grad("stencil2d", img, kern)
    return _kernel(stencil2d, _stencil.stencil2d,
                   lambda img, kern: (*cost.stencil2d(img, kern),
                                      torch.empty_like(img)), img, kern)


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
    check_no_grad("bitonic_stage", x)
    return _kernel(bitonic_stage, _bitonic.bitonic_stage,
                   lambda x, *_: (*cost.bitonic(x), torch.empty_like(x)),
                   x, dist, size, offset)


def bitonic_block(x, size: int, block: int = 2048, offset: int = 0):
    """The stages of a sort of x (L,) that stay inside one block of
    T = min(block, L) elements, in one launch on the card: every stage of
    the phases 2, 4, ..., size if size <= T (a sort's first launch, at
    size = T), else phase ``size``'s stages with dist T/2, ..., 1.
    Directions come from the global index offset + i, as in
    ``bitonic_stage``.  Exactly ``ref.bitonic_block_ref``: the
    composition of those ``bitonic_stage`` calls.  T must be a power of
    two >= 2 dividing L and offset (a shard's start, as in a sort), at most
    2048 on the card."""
    L = x.shape[0]
    block = min(block, L)
    if not (block >= 2 and block & (block - 1) == 0 and L % block == 0
            and offset % block == 0 and size >= 2 and size & (size - 1) == 0):
        raise ValueError(f"bitonic_block takes a power-of-two block >= 2 "
                         f"dividing L and offset, and a power-of-two size >= "
                         f"2, got block={block}, L={L}, offset={offset}, "
                         f"size={size}")
    if _on_cpu(x):
        return ref.bitonic_block_ref(x, size, block, offset)
    check_no_grad("bitonic_block", x)
    stages = len(ref.bitonic_block_stages(size, block))
    return _kernel(bitonic_block, _bitonic.bitonic_block,
                   lambda x, *_: (*cost.bitonic(x, stages),
                                  torch.empty_like(x)),
                   x, size, block, offset)


_WRAPPERS = (flash_attention, rmsnorm, add_rmsnorm, gated_rmsnorm,
             ssd_chunk_kernel, stencil2d, bitonic_stage, bitonic_block,
             flash_attention_bwd, rmsnorm_bwd, add_rmsnorm_bwd,
             gated_rmsnorm_bwd, ssd_chunk_bwd)


def launch_counts() -> typing.Dict[str, int]:
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launches() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0


reset_launches()
