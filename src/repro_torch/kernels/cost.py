"""The work of each hand-written kernel: (operations, bytes) of one call
from its operands' shapes.

Bytes count each input read once and each output written once;
operations count what the function needs, not what a kernel happens to
do (a causal attention counts its causal pairs only).  ``chip_smoke.py``
divides these by the card's peak rates for each kernel's bound, and
``repro_torch.core.hlo.analyze`` records them as the kernel's ``TraceOp``
(operations as FLOPs, bytes as HBM bytes) where it traces the kernel
path on the meta device.
"""
from __future__ import annotations

import typing

Cost = typing.Tuple[float, float]            # (operations, bytes)


def _pairs(sq: int, skv: int, causal: bool) -> float:
    return sq * (sq + 1) / 2 if causal else sq * skv


def flash_attention(q, k, causal: bool = True, with_lse: bool = False
                    ) -> Cost:
    """q (B,Sq,H,hd), k and v (B,Skv,K,hd): QK^T and PV over the
    (causal) pairs; q, k, v read, o (and the log-sum-exp) written."""
    B, Sq, H, hd = q.shape
    ops = 4 * B * H * hd * _pairs(Sq, k.shape[1], causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + (4 * B * H * Sq if with_lse else 0)
    return ops, nbytes


def flash_attention_bwd(q, k, lse, causal: bool = True) -> Cost:
    """2.5x the forward's operations (S and dP recomputed, dV, dQ, dK
    against S and PV); q, k, v, o, dO and lse read, dq, dk, dv
    written."""
    B, Sq, H, hd = q.shape
    ops = 2.5 * 4 * B * H * hd * _pairs(Sq, k.shape[1], causal)
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() \
        + 4 * lse.numel()
    return ops, nbytes


def rmsnorm(x, w) -> Cost:
    """4 operations an element; x and w read, out written."""
    return 4 * x.numel(), (2 * x.numel() + w.numel()) * x.element_size()


def add_rmsnorm(x, w) -> Cost:
    """The residual add and the norm, 5 operations an element; x, r and w
    read, h and out written."""
    return 5 * x.numel(), (4 * x.numel() + w.numel()) * x.element_size()


def gated_rmsnorm(x, w) -> Cost:
    """silu's negation, exp, add and division, the product, then the
    norm's 4: 9 an element; x, z and w read, out written."""
    return 9 * x.numel(), (3 * x.numel() + w.numel()) * x.element_size()


def rmsnorm_bwd(x, w, residual: bool = False) -> Cost:
    """12 operations an element; x (h), dy (and dh) and w read, dx and dw
    written."""
    n = x.numel()
    return 12 * n, ((3 + residual) * n + 2 * w.numel()) * x.element_size()


def ssd_chunk(x, Bm) -> Cost:
    """x (R,H,Q,P), Bm (R,H,Q,N), f32: the causal half of C B^T and of
    att @ x, and B^T x; x, dt, cs read once, B and C once a chunk (shared
    by the heads), y and the states written."""
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    pairs = Q * (Q + 1) / 2
    ops = R * H * (2 * pairs * N + 2 * pairs * P + 2 * Q * N * P)
    nbytes = 4 * (2 * R * H * Q * P + 2 * R * H * Q + 2 * R * Q * N
                  + R * H * N * P)
    return ops, nbytes


def gated_rmsnorm_bwd(x, w) -> Cost:
    """The gate again (silu's 4 and the product), the norm's backward 12,
    dx's product and dz's 6 (1 - sig, times z, plus 1, times sig, x and
    dg): 23 an element; x, z, dy and w read, dx, dz and dw written."""
    n = x.numel()
    return 23 * n, (5 * n + 2 * w.numel()) * x.element_size()


def ssd_chunk_bwd(x, Bm) -> Cost:
    """x (R,H,Q,P), Bm (R,H,Q,N), f32: over the causal pairs C B^T and
    dy x^T again, att^T dy, dG B and dG^T C; (B w) dS and x dS^T; x, dt,
    cs, dy and dS read once, B and C once a chunk, dx, ddt, dcs and the
    per-head dB and dC written."""
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    pairs = Q * (Q + 1) / 2
    ops = R * H * (2 * pairs * (3 * N + 2 * P) + 4 * Q * N * P)
    nbytes = 4 * (3 * R * H * Q * P + R * H * N * P + 4 * R * H * Q
                  + 2 * R * Q * N + 2 * R * H * Q * N)
    return ops, nbytes


def stencil2d(img, kern) -> Cost:
    """2 K^2 operations an output; img read and written once, the
    weights read."""
    H, W = img.shape
    K = kern.shape[0]
    return 2 * K * K * H * W, (2 * H * W + K * K) * img.element_size()


def bitonic(x, stages: int = 1) -> Cost:
    """One compare-exchange an element and stage; x read and written
    once."""
    return stages * x.numel(), 2 * x.numel() * x.element_size()
