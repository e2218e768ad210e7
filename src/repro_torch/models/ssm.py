"""Mamba2 (SSD, state-space duality) blocks (port of
``repro/models/ssm.py``).

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t x_t^T        (state N x P)
    y_t = C_t . S_t + D_h * x_t

computed in chunks of Q tokens: a masked quadratic form inside each
chunk and a short recurrence over chunk states across them.  With
``cfg.use_kernels`` the block runs ``kernels.ops.ssd_chunked``, whose
intra-chunk part is the hand-written CUDA kernel; otherwise it runs
``ssd_reference``, the plain version.  The reference's ``ssd_scan`` (a
memory trick for the same function, one chunk's tile live at a time) is
not ported.

Shapes: x (B,L,H,P)  dt (B,L,H)  A (H,)  B/C (B,L,G,N), G == 1 in every
config.  All SSD math is f32 whatever the model dtype.
"""
from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from . import layers as L

Params = typing.Dict[str, typing.Any]


# --------------------------------------------------------------------------
# core SSD (plain version)
# --------------------------------------------------------------------------

def ssd_reference(x, dt, A, Bm, Cm, chunk: int = 256, initial_state=None,
                  return_state: bool = False):
    """Chunked SSD in plain tensor ops. x (B,L,H,P) dt (B,L,H) A (H,)
    Bm/Cm (B,L,G,N) -> y (B,L,H,P) f32 [, final state (B,H,N,P) f32]."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    C = Lp // Q
    xc = x.reshape(Bsz, C, Q, H, P).float()
    dtc = dt.reshape(Bsz, C, Q, H).float()
    Bc = Bm.reshape(Bsz, C, Q, G, N).float()
    Cc = Cm.reshape(Bsz, C, Q, G, N).float()
    A = A.float()

    dA = dtc * A[None, None, None, :]                      # (B,C,Q,H) <= 0
    cs = torch.cumsum(dA, dim=2)                           # inclusive

    # ---- intra-chunk (diagonal blocks) --------------------------------
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,C,Q,Q,H) i,j
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    # exp of -inf above the diagonal, not where(mask, exp(seg), 0): the
    # same values, but exp(seg) overflows there once the chunk's decay
    # spans more than 88, and its backward would take 0 * inf = NaN
    decay = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                      -math.inf))
    qk = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)        # (B,C,Q,Q,G)
    hpg = H // G
    att = (qk[..., :, None]
           * decay.reshape(*decay.shape[:-1], G, hpg)).reshape(
               Bsz, C, Q, Q, H)
    att = att * dtc[:, :, None, :, :]                      # dt_j
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # ---- chunk states --------------------------------------------------
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)        # (B,C,Q,H)
    bdx = Bc[:, :, :, :, None, :].expand(Bsz, C, Q, G, hpg, N) \
        .reshape(Bsz, C, Q, H, N)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchnp",
                          bdx, decay_to_end * dtc, xc)     # (B,C,H,N,P)

    # ---- inter-chunk recurrence ----------------------------------------
    chunk_decay = torch.exp(cs[:, :, -1, :])               # (B,C,H)
    s = (initial_state.float() if initial_state is not None else
         torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device))
    s_in = []
    for c in range(C):
        s_in.append(s)                                     # state entering c
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    s_in = torch.stack(s_in, dim=1)                        # (B,C,H,N,P)

    # ---- off-diagonal (carry-in state) ---------------------------------
    cdx = Cc[:, :, :, :, None, :].expand(Bsz, C, Q, G, hpg, N) \
        .reshape(Bsz, C, Q, H, N)
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", cdx, s_in,
                         torch.exp(cs))
    y = (y_diag + y_off).reshape(Bsz, Lp, H, P)[:, :L]
    return (y, s) if return_state else y


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token SSD update.  state (B,H,N,P); x (B,H,P); dt (B,H);
    Bm/Cm (B,G,N) -> (y (B,H,P), new state)."""
    H = state.shape[1]
    hpg = H // Bm.shape[1]
    x, dt = x.float(), dt.float()
    dA = torch.exp(dt * A[None, :])                        # (B,H)
    Bh = Bm.float().repeat_interleave(hpg, dim=1)          # (B,H,N)
    Ch = Cm.float().repeat_interleave(hpg, dim=1)
    new = dA[:, :, None, None] * state + \
        (Bh * dt[:, :, None])[..., None] * x[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Ch, new)
    return y, new


# --------------------------------------------------------------------------
# depthwise causal conv (width W, over the channels of xBC)
# --------------------------------------------------------------------------

def causal_conv(x, w, b):
    """x (B,L,D), w (W,D), b (D,) -> (B,L,D); y_t = sum_i x_{t-W+1+i} w_i."""
    W = w.shape[0]
    L = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + L, :] * w[i]
    return y + b


def conv_step(conv_state, x_t, w, b):
    """conv_state (B,W-1,D); x_t (B,D) -> (y_t (B,D), new state)."""
    full = torch.cat([conv_state, x_t[:, None, :]], dim=1)    # (B,W,D)
    y = (full * w).sum(dim=1) + b
    return y, full[:, 1:, :]


# --------------------------------------------------------------------------
# Mamba2 block
# --------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg, n_layers: int) -> Params:
    """Weights of ``n_layers`` Mamba2 blocks, stacked on axis 0, with the
    reference's column-block layout (wz | wx | wbc | wdt, conv_x |
    conv_bc).  A in [1, 16], dt_bias = softplus^-1(U[1e-3, 1e-1]); the
    conv weights, A_log, D and dt_bias are f32, the rest the model
    dtype."""
    dt_, n, d = cfg.torch_dtype, n_layers, cfg.d_model
    H, W, di = cfg.ssm_heads, cfg.ssm_conv_width, cfg.d_inner
    gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
    f32, dev = torch.float32, gen.device

    def uniform(lo, hi):
        return torch.empty((n, H), dtype=f32, device=dev).uniform_(
            lo, hi, generator=L.draws(gen))

    a = torch.exp(uniform(math.log(1.0), math.log(16.0)))
    u = uniform(1e-3, 1e-1)
    return {
        "wz": L.dense_init(gen, (n, d, di), dt_),
        "wx": L.dense_init(gen, (n, d, di), dt_),
        "wbc": L.dense_init(gen, (n, d, gn2), dt_),
        "wdt": L.dense_init(gen, (n, d, H), dt_),
        "conv_xw": L.dense_init(gen, (n, W, di), f32, scale=0.5),
        "conv_xb": torch.zeros((n, di), dtype=f32, device=dev),
        "conv_bcw": L.dense_init(gen, (n, W, gn2), f32, scale=0.5),
        "conv_bcb": torch.zeros((n, gn2), dtype=f32, device=dev),
        "A_log": torch.log(a),
        "D": torch.ones((n, H), dtype=f32, device=dev),
        "dt_bias": u + torch.log(-torch.expm1(-u)),          # inv softplus
        "norm_w": torch.ones((n, di), dtype=dt_, device=dev),
        "out_proj": L.dense_init(gen, (n, di, d), dt_),
    }


def _gated_out(p: Params, y, z, cfg):
    """rms_norm(y * silu(z)) @ out_proj, y already in the model dtype."""
    y = L.gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps,
                         use_kernel=cfg.use_kernels)
    return y @ p["out_proj"]


def mamba2_block(p: Params, x, cfg, initial_state=None,
                 return_state: bool = False):
    """Full-sequence Mamba2 mixer. x (B,L,d) -> y (B,L,d) [, state
    {"ssm" (B,H,N,P) f32, "conv" (B,W-1,conv_dim) f32}]."""
    B, L_, _ = x.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    z = x @ p["wz"]
    xr = (x @ p["wx"]).float()                              # (B,L,d_inner)
    bc = (x @ p["wbc"]).float()                             # (B,L,2GN)
    dt = x @ p["wdt"]                                       # (B,L,H)
    xs = F.silu(causal_conv(xr, p["conv_xw"], p["conv_xb"]))
    bcs = F.silu(causal_conv(bc, p["conv_bcw"], p["conv_bcb"]))
    xs = xs.reshape(B, L_, H, P)
    Bm = bcs[..., :G * N].reshape(B, L_, G, N)
    Cm = bcs[..., G * N:].reshape(B, L_, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    ssd = kops.ssd_chunked if cfg.use_kernels else ssd_reference
    out = ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
              initial_state=initial_state, return_state=return_state)
    y, final = out if return_state else (out, None)
    y = y + p["D"][None, None, :, None] * xs
    y = _gated_out(p, y.reshape(B, L_, cfg.d_inner).to(x.dtype), z, cfg)
    if not return_state:
        return y
    # conv tail: the last W-1 pre-activation channels feed future steps
    W = cfg.ssm_conv_width
    raw = torch.cat([xr, bc], dim=-1)
    tail = F.pad(raw, (0, 0, max(0, W - 1 - L_), 0))[:, -(W - 1):]
    return y, {"ssm": final, "conv": tail}


def mamba2_step(p: Params, x_t, state, cfg):
    """One-token Mamba2 step. x_t (B,d); state {"ssm", "conv"} ->
    (y (B,d), new state)."""
    B = x_t.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    di = cfg.d_inner
    z = x_t @ p["wz"]
    xr = (x_t @ p["wx"]).float()
    bc = (x_t @ p["wbc"]).float()
    dt = x_t @ p["wdt"]
    xbc = torch.cat([xr, bc], dim=-1)
    w = torch.cat([p["conv_xw"], p["conv_bcw"]], dim=-1)
    b = torch.cat([p["conv_xb"], p["conv_bcb"]], dim=-1)
    xbc_c, conv_new = conv_step(state["conv"], xbc, w, b)
    xbc_c = F.silu(xbc_c)
    xs = xbc_c[..., :di].reshape(B, H, P)
    Bm = xbc_c[..., di:di + G * N].reshape(B, G, N)
    Cm = xbc_c[..., di + G * N:].reshape(B, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssm_new = ssd_decode_step(state["ssm"], xs, dt, A, Bm, Cm)
    y = y + p["D"][None, :, None] * xs
    y = _gated_out(p, y.reshape(B, di).to(x_t.dtype), z, cfg)
    return y, {"ssm": ssm_new, "conv": conv_new}


def init_mamba_state(cfg, batch: int, device) -> dict:
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    return {"ssm": torch.zeros((batch, H, N, P), dtype=f32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv_width - 1,
                                 cfg.conv_dim), dtype=f32, device=device)}
