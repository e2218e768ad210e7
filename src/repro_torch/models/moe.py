"""Mixture-of-Experts FFN, GShard-style capacity dispatch built by scatter
(port of ``repro/models/moe.py``).

Routing builds (E, C) *index* buffers, not a (tokens, experts, capacity)
one-hot: O(T k) routing metadata and O(E C d) activations.  Assignments
beyond an expert's capacity C fall into a dump slot and contribute zero,
as GShard's capacity factor drops them.

The functions keep the reference's signatures.  Inside, every step runs
on a leading group axis, so ``grouped_moe_ffn``'s per-group routing is
one batch of tensor ops (the reference vmaps it) and no Python loop
over groups.  Capacities come from shapes (``capacity``), and nothing
reads device memory on the host: the routing traces on ``meta`` as it
runs on the card.  The router's logits are f32 (``x.float() @ router``);
the experts run in the model dtype.  The expert products ``ecd,edf->ecf``
are plain batched matrix products, as in the reference, which leaves
them to XLA: no kernel of the port's.
"""
from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

from .layers import Params, dense_init

Meta = typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def init_moe(gen: torch.Generator, cfg, n_layers: int) -> Params:
    """Weights of ``n_layers`` MoE FFNs, stacked on axis 0: the f32
    router (n, d, E) and the experts' SwiGLU (n, E, d, f), (n, E, f, d)."""
    d, f, E, dt, n = (cfg.d_model, cfg.d_ff, cfg.num_experts,
                      cfg.torch_dtype, n_layers)
    return {"router": dense_init(gen, (n, d, E), torch.float32),
            "wg": dense_init(gen, (n, E, d, f), dt),
            "wu": dense_init(gen, (n, E, d, f), dt),
            "wd": dense_init(gen, (n, E, f, d), dt)}


def capacity(tokens: int, cfg) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor)
    return max(8, int(math.ceil(c / 8) * 8))  # padded to a multiple of 8


# --------------------------------------------------------------------------
# group-batched steps: a leading axis G of independent token groups
# --------------------------------------------------------------------------

def _route(p: Params, x, cfg):
    """x (G,T,d) -> expert_idx (G,T,k) int32, gate_w (G,T,k) f32, aux
    (G,) f32."""
    logits = x.float() @ p["router"]                        # (G,T,E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the k largest, ties to the lower index.  torch.topk
    # promises no order among ties; a stable descending sort keeps equal
    # probabilities in index order
    gate_w, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    k = cfg.experts_per_token
    gate_w, expert_idx = gate_w[..., :k], expert_idx[..., :k]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch): E * mean(frac_tokens * frac_probs)
    E = cfg.num_experts
    top1 = (expert_idx[..., :1]
            == torch.arange(E, device=x.device)).float()  # one-hot
    aux = E * torch.mean(top1.mean(-2) * probs.mean(-2), dim=-1)
    return expert_idx.int(), gate_w, aux


def _dispatch(expert_idx, T: int, E: int, C: int):
    """expert_idx (G,T,k) -> dispatch_idx (G,E,C) int32 in [0..T] (T is
    the zero-pad row), pos_c (G,T*k) int32 clipped to C, keep (G,T*k)."""
    G, _, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(G, T * k).long()
    onehot = (flat_e[..., None]
              == torch.arange(E, device=dev)).int()         # (G,T*k,E)
    pos = torch.cumsum(onehot, dim=1) - onehot              # exclusive count
    pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                       # dump slot
    token_ids = torch.arange(T, dtype=torch.int32, device=dev)[:, None] \
        .expand(T, k).reshape(T * k).expand(G, T * k)
    buf = torch.full((G, E, C + 1), T, dtype=torch.int32, device=dev)
    groups = torch.arange(G, device=dev)[:, None]
    # the kept (expert, position) pairs are distinct, so the only targets
    # written twice are in the dump column C, which [..., :C] drops:
    # which of its writers wins does not matter
    buf[groups, flat_e, pos_c] = token_ids
    return buf[..., :C], pos_c.int(), keep


def _gather(x, dispatch_idx):
    """x (G,T,d), dispatch_idx (G,E,C) -> the expert inputs (G,E,C,d),
    zero rows at the index T."""
    G = x.shape[0]
    x_pad = F.pad(x, (0, 0, 0, 1))                          # (G,T+1,d)
    groups = torch.arange(G, device=x.device)[:, None, None]
    return x_pad[groups, dispatch_idx.long()]


def _combine(ye, expert_idx, gate_w, pos_c, keep, k: int):
    """ye (G,E,C,d) expert outputs -> (G,T,d): each token's k outputs
    weighted by its gates, a dropped assignment reading the zero dump
    slot."""
    G, E, C, d = ye.shape
    T = expert_idx.shape[1]
    ye_pad = F.pad(ye, (0, 0, 0, 1))                        # (G,E,C+1,d)
    groups = torch.arange(G, device=ye.device)[:, None]
    out_rows = ye_pad[groups, expert_idx.reshape(G, T * k).long(),
                      pos_c.long()]                         # (G,T*k,d)
    w = (gate_w.reshape(G, T * k) * keep).to(out_rows.dtype)
    return (out_rows * w[..., None]).reshape(G, T, k, d).sum(dim=2)


# --------------------------------------------------------------------------
# the reference's functions
# --------------------------------------------------------------------------

def route(p: Params, x, cfg):
    """x (T,d) -> (expert_idx (T,k) int32, gate_w (T,k) f32, aux_loss)."""
    expert_idx, gate_w, aux = _route(p, x[None], cfg)
    return expert_idx[0], gate_w[0], aux[0]


def build_dispatch(expert_idx, T: int, E: int, C: int):
    """expert_idx (T,k) -> (dispatch_idx (E,C) int32 in [0..T] where T is
    the zero-pad slot, pos (T*k,) int32 clipped to C, keep (T*k,) bool).
    Token-major flattening keeps each token's k assignments contiguous,
    so combine is a reshape and a sum."""
    dispatch_idx, pos_c, keep = _dispatch(expert_idx[None], T, E, C)
    return dispatch_idx[0], pos_c[0], keep[0]


def expert_ffn(p: Params, xe):
    """xe (E,C,d) -> (E,C,d): each expert's SwiGLU by batched products."""
    g = F.silu(torch.einsum("ecd,edf->ecf", xe, p["wg"]))
    u = torch.einsum("ecd,edf->ecf", xe, p["wu"])
    return torch.einsum("ecf,efd->ecd", g * u, p["wd"])


def moe_ffn(p: Params, x, cfg):
    """The MoE FFN of a token block. x (T,d) -> (y (T,d), aux).  With
    ``cfg.moe_groups > 1`` and T a multiple of it, routing runs per token
    group (``grouped_moe_ffn``), as in the reference; the branch decides
    which assignments are dropped."""
    T = x.shape[0]
    if cfg.moe_groups > 1 and T % cfg.moe_groups == 0:
        return grouped_moe_ffn(p, x, cfg)
    xe, meta, aux = dispatch_local(p, x, cfg, capacity(T, cfg))
    y = combine_local(expert_ffn(p, xe), meta, cfg)
    return y.to(x.dtype), aux


def grouped_moe_ffn(p: Params, x, cfg):
    """Per-group dispatch: x (T,d) viewed as (Gr, T/Gr, d); routing,
    position counts and capacity are group-local, and the experts see the
    groups' slots side by side, (E, Gr*Cg, d).  GShard with group =
    device: drops can differ from the global formulation where a group is
    over-subscribed."""
    T, d = x.shape
    Gr, E, k = cfg.moe_groups, cfg.num_experts, cfg.experts_per_token
    Tg = T // Gr
    Cg = capacity(Tg, cfg)
    xg = x.reshape(Gr, Tg, d)
    expert_idx, gate_w, aux = _route(p, xg, cfg)
    dispatch_idx, pos_c, keep = _dispatch(expert_idx, Tg, E, Cg)
    xe = _gather(xg, dispatch_idx)                          # (Gr,E,Cg,d)
    ye = expert_ffn(p, xe.transpose(0, 1).reshape(E, Gr * Cg, d))
    ye = ye.reshape(E, Gr, Cg, d).transpose(0, 1)           # (Gr,E,Cg,d)
    y = _combine(ye, expert_idx, gate_w, pos_c, keep, k)    # (Gr,Tg,d)
    return y.reshape(T, d).to(x.dtype), torch.mean(aux)


# --------------------------------------------------------------------------
# D-mode building blocks (around an all-to-all over the expert axis)
# --------------------------------------------------------------------------

def dispatch_local(p: Params, x, cfg, C: int):
    """Route a local token shard and build its (E, C, d) send buffer;
    returns (xe, meta, aux), meta = (expert_idx, gate_w, pos_c, keep)."""
    T = x.shape[0]
    expert_idx, gate_w, aux = route(p, x, cfg)
    dispatch_idx, pos_c, keep = build_dispatch(expert_idx, T,
                                               cfg.num_experts, C)
    xe = _gather(x[None], dispatch_idx[None])[0]            # (E,C,d)
    return xe, (expert_idx, gate_w, pos_c, keep), aux


def combine_local(ye, meta: Meta, cfg):
    """Invert ``dispatch_local``: ye (E,C,d) expert outputs -> (T,d)."""
    expert_idx, gate_w, pos_c, keep = meta
    return _combine(ye[None], expert_idx[None], gate_w[None], pos_c[None],
                    keep[None], cfg.experts_per_token)[0]
