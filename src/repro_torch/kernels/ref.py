"""Plain PyTorch versions of the ported kernels (port of
``repro/kernels/ref.py``).

Each function is the semantic definition its CUDA kernel must match.
The wrappers in ``ops.py`` run them for tensors on the CPU; on the card
``chip_smoke.py`` holds each kernel against them.
"""
from __future__ import annotations

import math

import torch


def _f32(t):
    """t in f32, the kernels' arithmetic; f64 stays f64, so that
    ``torch.autograd.gradcheck`` can hold the plain versions in f64."""
    return t if t.dtype == torch.float64 else t.float()


def flash_attention_ref(q, k, v, causal: bool = True):
    """q (B,Sq,H,hd); k/v (B,Skv,K,hd) GQA -> (B,Sq,H,hd), f32 math.

    The causal mask is aligned bottom-right (offset Skv-Sq), as in the
    reference oracle; the kernel only takes Sq == Skv, where top-left
    and bottom-right alignment agree."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = _f32(q.reshape(B, Sq, K, G, hd))
    s = torch.einsum("bskgh,btkh->bkgst", qg, _f32(k)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, _f32(v))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _causal_top_left(q, k, causal: bool):
    """The flash kernels' mask, key kj visible to row qi iff kj <= qi
    (top-left); None when not causal.  Causal calls take Sq == Skv, where
    it equals ``flash_attention_ref``'s bottom-right mask."""
    Sq, Skv = q.shape[1], k.shape[1]
    if not causal:
        return None
    if Sq != Skv:
        raise ValueError(f"causal flash attention takes Sq == Skv, got "
                         f"{Sq} != {Skv}")
    return torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril()


def _flash_scores(q, k, causal: bool):
    """scale * Q K^T in f32 as (B, K, G, Sq, Skv), -inf where masked."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = _f32(q.reshape(B, Sq, K, H // K, hd))
    s = torch.einsum("bskgh,btkh->bkgst", qg, _f32(k)) / math.sqrt(hd)
    mask = _causal_top_left(q, k, causal)
    return s if mask is None else s.masked_fill(~mask, float("-inf"))


def flash_attention_lse_ref(q, k, v, causal: bool = True):
    """The forward's log-sum-exp of each row's scaled scores, in natural-log
    units: (B, H, Sq) f32, head h = kv-head * G + g as in the kernels."""
    B, Sq, H, _ = q.shape
    return torch.logsumexp(_flash_scores(q, k, causal), dim=-1) \
        .reshape(B, H, Sq)


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """Gradients (dq, dk, dv) of flash attention, step by step as the
    backward kernel computes them, in f32, each rounded to its input's
    dtype at the end:

        D  = rowsum(dO * O)
        P  = exp(scale * Q K^T - lse)      (0 where masked)
        dV = P^T dO        dS = P * (dO V^T - D)
        dQ = scale * dS K  dK = scale * dS^T Q

    dK and dV are summed over the G = H / K q-heads of each kv-head.
    o (B,Sq,H,hd) is the forward's output, lse (B,H,Sq) its log-sum-exp,
    do (B,Sq,H,hd) the incoming gradient."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    grp = (lambda t: _f32(t.reshape(B, Sq, K, G, hd)))
    qg, og, dog = grp(q), grp(o), grp(do)
    p = torch.exp(_flash_scores(q, k, causal)
                  - _f32(lse).reshape(B, K, G, Sq)[..., None])
    d = (dog * og).sum(-1).permute(0, 2, 3, 1)              # (B,K,G,Sq)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, _f32(v))
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bkgst,btkh->bskgh", ds, _f32(k)) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """x (..., d), w (d,) -> x * rsqrt(mean(x^2) + eps) * w, f32 math,
    output in x's dtype."""
    xf = _f32(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * _f32(w)).to(x.dtype)


def add_rmsnorm_ref(x, r, w, eps: float = 1e-6):
    """The residual add in front of a pre-norm: h = x + r (rounded to the
    dtype, as the eager add is), out = rmsnorm_ref(h, w) -> (h, out)."""
    h = x + r
    return h, rmsnorm_ref(h, w, eps)


def _rmsnorm_bwd_f32(x, w, dy, eps: float):
    """(dx, dw) of rmsnorm in f32: per row r = rsqrt(mean(x^2) + eps) and
    g = dy * w; dx = r g - x r^3 mean(g x); dw = sum over rows of dy x r."""
    xf, dyf = _f32(x), _f32(dy)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = dyf * _f32(w)
    dx = r * g - xf * r ** 3 * (g * xf).mean(dim=-1, keepdim=True)
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx, dw


def rmsnorm_bwd_ref(x, w, dy, eps: float = 1e-6):
    """Gradients (dx, dw) of ``rmsnorm_ref(x, w)`` for the incoming dy,
    in f32, rounded to x's and w's dtypes at the end."""
    dx, dw = _rmsnorm_bwd_f32(x, w, dy, eps)
    return dx.to(x.dtype), dw.to(w.dtype)


def add_rmsnorm_bwd_ref(h, w, dout, dh=None, eps: float = 1e-6):
    """Gradients of ``add_rmsnorm_ref``'s (h, out) for the incoming dh and
    dout, from the h the forward wrote: (dx, dw), where dx is the gradient
    of both addends, dh + the norm's input gradient (dh None counts as
    zero); f32, rounded to h's and w's dtypes at the end."""
    dx, dw = _rmsnorm_bwd_f32(h, w, dout, eps)
    if dh is not None:
        dx = dx + _f32(dh)
    return dx.to(h.dtype), dw.to(w.dtype)


def gated_rmsnorm_ref(x, z, w, eps: float = 1e-6):
    """Mamba2's gated norm: rmsnorm_ref(x * silu(z), w), silu(z) and the
    product each rounded to the dtype, as the eager ops are."""
    return rmsnorm_ref(x * torch.nn.functional.silu(z), w, eps)


def gated_rmsnorm_bwd_ref(x, z, w, dy, eps: float = 1e-6):
    """Gradients (dx, dz, dw) of ``gated_rmsnorm_ref(x, z, w)`` for the
    incoming dy, in f32, each rounded once to its input's dtype at the
    end.  With s = silu(z) and g = x * s, rounded as the forward rounds
    them, (dg, dw) is the rmsnorm backward at g, and

        dx = dg * s        dz = dg * x * sig(z) * (1 + z * (1 - sig(z)))
    """
    s = torch.nn.functional.silu(z)
    dg, dw = _rmsnorm_bwd_f32(x * s, w, dy, eps)
    zf = _f32(z)
    sig = torch.sigmoid(zf)
    dx = dg * _f32(s)
    dz = dg * _f32(x) * sig * (1 + zf * (1 - sig))
    return dx.to(x.dtype), dz.to(z.dtype), dw.to(w.dtype)


def _causal_decay(cs):
    """exp(cs_i - cs_j) for i >= j, else 0: (..., Q, Q) from cs (..., Q).
    exp of -inf above the diagonal, not where(mask, exp(seg), 0), whose
    backward is 0 * inf = NaN wherever exp(seg) overflows there."""
    Q = cs.shape[-1]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cs.device).tril()
    seg = cs[..., :, None] - cs[..., None, :]
    return torch.exp(seg.masked_fill(~mask, -math.inf))


def ssd_chunk_ref(x, dt, cs, Bm, Cm):
    """Intra-chunk SSD.  x (R,H,Q,P); dt/cs (R,H,Q); Bm/Cm (R,H,Q,N)
    -> (y_diag (R,H,Q,P) f32, states (R,H,N,P) f32), f32 math (f64
    stays f64):

        att[i,j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j   (i >= j, else 0)
        y_diag   = att @ x
        states   = (B * exp(cs_last - cs) * dt)^T @ x
    """
    x, dt, cs, Bm, Cm = (_f32(t) for t in (x, dt, cs, Bm, Cm))
    decay = _causal_decay(cs)                              # (R,H,Q,Q) i,j
    att = torch.einsum("rhin,rhjn->rhij", Cm, Bm) * decay * dt[..., None, :]
    y = torch.einsum("rhij,rhjp->rhip", att, x)
    w = torch.exp(cs[..., -1:] - cs) * dt                  # (R,H,Q)
    s = torch.einsum("rhqn,rhq,rhqp->rhnp", Bm, w, x)
    return y, s


def ssd_chunk_bwd_ref(x, dt, cs, Bm, Cm, dy, dS):
    """Gradients (dx, ddt, dcs, dB, dC) of ``ssd_chunk_ref`` for the
    incoming dy (R,H,Q,P) and dS (R,H,N,P), in closed form, f32 (f64
    stays f64); dB and dC per head, (R,H,Q,N).  Per (chunk, head), with
    G = C B^T, Lm_ij = exp(cs_i - cs_j) [i >= j], att = G * Lm * dt_j,
    w_j = exp(cs_last - cs_j) dt_j, dA = dy x^T, Pm = dA * att and
    u_j = sum_{n,p} B_jn x_jp dS_np:

        dx    = att^T dy + (B * w) dS
        dC    = (dA * Lm * dt_j) B
        dB    = (dA * Lm * dt_j)^T C + w * (x dS^T)
        ddt_j = sum_i dA_ij G_ij Lm_ij + exp(cs_last - cs_j) u_j
        dcs_i = sum_j Pm_ij - sum_k Pm_ki - w_i u_i  (+ sum_j w_j u_j at
                the last row)
    """
    x, dt, cs, Bm, Cm, dy, dS = (_f32(t) for t in (x, dt, cs, Bm, Cm, dy,
                                                   dS))
    Lm = _causal_decay(cs)                                 # (R,H,Q,Q) i,j
    Ldt = Lm * dt[..., None, :]
    G = torch.einsum("rhin,rhjn->rhij", Cm, Bm)
    att = G * Ldt
    dA = torch.einsum("rhip,rhjp->rhij", dy, x)
    dG = dA * Ldt
    Pm = dA * att
    decay = torch.exp(cs[..., -1:] - cs)                   # (R,H,Q)
    w = decay * dt
    xdS = torch.einsum("rhjp,rhnp->rhjn", x, dS)
    u = (Bm * xdS).sum(-1)
    dx = torch.einsum("rhij,rhip->rhjp", att, dy) \
        + torch.einsum("rhjn,rhnp->rhjp", Bm * w[..., None], dS)
    dC = torch.einsum("rhij,rhjn->rhin", dG, Bm)
    dB = torch.einsum("rhij,rhin->rhjn", dG, Cm) + w[..., None] * xdS
    ddt = (dA * G * Lm).sum(-2) + decay * u
    dcs = Pm.sum(-1) - Pm.sum(-2) - w * u
    dcs[..., -1] += (w * u).sum(-1)
    return dx, ddt, dcs, dB, dC


def stencil2d_ref(img, kern):
    """img (H, W), kern (K, K) -> same-padded K x K correlation (H, W):
    out[y, x] = sum over (dy, dx) of kern[dy, dx] * img[y+dy-r, x+dx-r],
    r = K // 2, zero outside the image; f32 sums in (dy, dx) order,
    output in img's dtype."""
    K = kern.shape[0]
    r = K // 2
    H, W = img.shape
    pad = torch.nn.functional.pad(img.float(), (r, r, r, r))
    kf = kern.float()
    out = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for dy in range(K):
        for dx in range(K):
            out = out + kf[dy, dx] * pad[dy:dy + H, dx:dx + W]
    return out.to(img.dtype)


def bitonic_stage_ref(x, dist: int, size: int, offset: int = 0):
    """One compare-exchange stage over x (L,): partner = i ^ dist,
    ascending iff ((offset + i) & size) == 0.  ``offset`` is the global
    index of x[0], so that a shard sees the direction of its global
    indices; at 0 this is the reference's stage unchanged."""
    idx = torch.arange(x.shape[0], device=x.device)
    partner = idx ^ dist
    other = x[partner]
    asc = ((idx + offset) & size) == 0
    take_min = (idx < partner) == asc
    return torch.where(take_min, torch.minimum(x, other),
                       torch.maximum(x, other))


def bitonic_block_stages(size: int, tile: int):
    """(size, dist) of the stages ``bitonic_block_ref`` runs, in order:
    with size <= tile every stage of the phases 2, 4, ..., size; with
    size > tile the stages of phase ``size`` with dist tile/2, ..., 1.
    Each stays inside one aligned tile of ``tile`` elements."""
    sizes = [size] if size > tile else [1 << k for k in
                                        range(1, size.bit_length())]
    return [(s, d) for s in sizes
            for d in (1 << k for k in
                      range(min(s, tile).bit_length() - 2, -1, -1))]


def bitonic_block_ref(x, size: int, tile: int = 2048, offset: int = 0):
    """The composition of ``bitonic_stage_ref`` over
    ``bitonic_block_stages(size, tile)``."""
    for s, d in bitonic_block_stages(size, tile):
        x = bitonic_stage_ref(x, d, s, offset)
    return x


def bitonic_sort_ref(x):
    """Full bitonic sort of x (L,), L a power of two, from
    ``bitonic_stage_ref``."""
    L = x.shape[0]
    size = 2
    while size <= L:
        dist = size // 2
        while dist >= 1:
            x = bitonic_stage_ref(x, dist, size)
            dist //= 2
        size *= 2
    return x
