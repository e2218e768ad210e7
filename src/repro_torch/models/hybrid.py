"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
(port of ``repro/models/hybrid.py``).

After every ``attn_every``-th SSM layer the single shared attention +
SwiGLU block (one parameter set, reused) runs.  The param tree keeps the
reference's layout:

    G = num_layers // attn_every   super-blocks of (attn_every SSM + attn)
    R = num_layers % attn_every    tail SSM layers

SSM params stacked (G, attn_every, ...) plus a tail (R, ...); the shared
block unstacked; its KV cache one per application, (G, B, T, K, hd); the
SSM states and conv tails (G, attn_every, B, ...) and (R, B, ...), f32.
The loops are Python where the reference scans.  On the kernel path each
SSM layer runs the SSD chunk kernel and the gated norm, the shared block
``cfg.attn_impl``'s attention, and each residual add is fused into the
next norm's launch (the last into ln_f), where the reference adds and
then normalises: the values are the reference's.
"""
from __future__ import annotations

import typing

import torch

from repro_torch import resolve_device

from . import layers as L
from . import ssm as S
from .base import ModelConfig

Params = typing.Dict[str, typing.Any]


def _gr(cfg: ModelConfig):
    g = cfg.num_layers // cfg.attn_every
    r = cfg.num_layers - g * cfg.attn_every
    return g, r


def init(seed, cfg: ModelConfig, device="cuda") -> Params:
    """Random params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``).  The draws differ from the reference's ``jax.random``
    ones; parity tests convert the reference's params with
    ``repro_torch.convert.params_from_jax`` instead."""
    device = resolve_device(device)
    gen = L.generator(seed, device)
    dt, d = cfg.torch_dtype, cfg.d_model
    G, R = _gr(cfg)
    K = cfg.attn_every
    p: Params = L.init_embed(gen, cfg)
    p["blocks"] = {
        "ssm": {k: v.reshape(G, K, *v.shape[1:]) for k, v in
                S.init_mamba2(gen, cfg, G * K).items()},
        "ln": torch.ones((G, K, d), dtype=dt, device=device)}
    if R:
        p["tail"] = {"ssm": S.init_mamba2(gen, cfg, R),
                     "ln": torch.ones((R, d), dtype=dt, device=device)}
    p["shared"] = {
        "attn": L.unstack(L.init_attention(gen, cfg, 1)),
        "mlp": L.unstack(L.init_swiglu(gen, cfg, 1)),
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
    }
    p["ln_f"] = torch.ones((d,), dtype=dt, device=device)
    return p


def _add_norm(h, r, w, cfg: ModelConfig):
    return L.add_rms_norm(h, r, w, cfg.norm_eps, use_kernel=cfg.use_kernels)


def _ssm_layers(p: Params, cfg: ModelConfig):
    """[(g, i, layer params)] of every SSM layer in order: super-block g's
    i-th, then the tail's (g = None).  Each stacked leaf is cut by one
    ``unbind`` a level (``layers.layer_slices``)."""
    G, R = _gr(cfg)
    out = [(g, i, lp)
           for g, bp in enumerate(L.layer_slices(p["blocks"], G))
           for i, lp in enumerate(L.layer_slices(bp, cfg.attn_every))]
    if R:
        out += [(None, i, lp)
                for i, lp in enumerate(L.layer_slices(p["tail"], R))]
    return out


def _states(cache: dict, g, i: int):
    """Views of SSM layer (g, i)'s state and conv tail in ``cache`` (g
    None: the tail's i-th layer)."""
    if g is None:
        return cache["ssm_tail"][i], cache["conv_tail"][i]
    return cache["ssm"][g, i], cache["conv"][g, i]


def _shared_block(sp: Params, h, r, cfg: ModelConfig, positions,
                  kv_cache=None, cache_pos=None):
    """The shared attention + SwiGLU block from h and the pending residual
    branch r: (h, its MLP output, (k, v) or the updated cache)."""
    h, x = _add_norm(h, r, sp["ln1"], cfg)
    a, kv = L.attention_block(sp["attn"], x, cfg, positions=positions,
                              causal=kv_cache is None, kv_cache=kv_cache,
                              cache_pos=cache_pos)
    h, x = _add_norm(h, a, sp["ln2"], cfg)
    return h, L.swiglu(sp["mlp"], x), kv


def _run(p: Params, cfg: ModelConfig, tokens, cache=None):
    """The stack over the whole sequence: (h, the last residual branch r)
    before ln_f.  With ``cache``, each SSM layer's final state and conv
    tail and each shared application's k/v go into it IN PLACE (rows
    [0, S) of k/v)."""
    h, r = L.embed(p, tokens), None
    Sq = h.shape[1]
    positions = torch.arange(Sq, device=h.device)
    K = cfg.attn_every
    for g, i, lp in _ssm_layers(p, cfg):
        h, x = _add_norm(h, r, lp["ln"], cfg)
        if cache is None:
            r = S.mamba2_block(lp["ssm"], x, cfg)
        else:
            r, st = S.mamba2_block(lp["ssm"], x, cfg, return_state=True)
            ssm_c, conv_c = _states(cache, g, i)
            ssm_c.copy_(st["ssm"])
            conv_c.copy_(st["conv"])
        if g is not None and i == K - 1:
            h, r, (k, v) = _shared_block(p["shared"], h, r, cfg, positions)
            if cache is not None:
                cache["k"][g, :, :Sq] = k
                cache["v"][g, :, :Sq] = v
    return h, r


def forward(p: Params, cfg: ModelConfig, tokens):
    """tokens (B,S) int -> (logits (B,S,V) f32, aux 0.0)."""
    h, r = _run(p, cfg, tokens)
    h = _add_norm(h, r, p["ln_f"], cfg)[1]
    return L.unembed(p, h, cfg), 0.0


def loss_fn(p: Params, cfg: ModelConfig, batch):
    """Mean next-token NLL of ``batch`` ({"tokens", "targets"[, "mask"]})."""
    logits, _ = forward(p, cfg, batch["tokens"])
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """Zero KV caches (G, batch, max_seq, K, hd) in ``dtype`` (the model's
    by default), SSM states (G, attn_every, batch, H, N, P) and conv tails
    (G, attn_every, batch, W-1, conv_dim) f32, and the tail's (R, batch,
    ...) where R > 0."""
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    G, R = _gr(cfg)
    K = cfg.attn_every
    kv = (G, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(kv, dtype=dt, device=device),
             "v": torch.zeros(kv, dtype=dt, device=device)}
    state = S.init_mamba_state(cfg, G * K * batch, device)
    cache.update({name: v.reshape(G, K, batch, *v.shape[1:])
                  for name, v in state.items()})
    if R:
        state = S.init_mamba_state(cfg, R * batch, device)
        cache.update({f"{name}_tail": v.reshape(R, batch, *v.shape[1:])
                      for name, v in state.items()})
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def prefill(p: Params, cfg: ModelConfig, tokens, cache: dict):
    """Run the prompt from zero states, fill the cache IN PLACE (every SSM
    layer's state and conv tail, each shared application's k/v rows [0,
    S)) and return the logits of the last position and the cache with
    ``pos = S``."""
    h, r = _run(p, cfg, tokens, cache)
    h = L.rms_norm(h[:, -1:] + r[:, -1:], p["ln_f"], cfg.norm_eps,
                   use_kernel=cfg.use_kernels)          # the last row only
    cache = dict(cache, pos=torch.tensor(tokens.shape[1], dtype=torch.int32,
                                         device=cache["k"].device))
    return L.unembed(p, h, cfg)[:, 0], cache


def decode_step(p: Params, cfg: ModelConfig, cache: dict, token):
    """token (B,) int -> (logits (B,V) f32, cache).  One new token per
    row; ``cache["pos"]`` is a scalar or (B,) per-slot positions.  The
    states and KV caches are updated in place; the returned cache has
    ``pos + 1``."""
    h, r = L.embed(p, token[:, None])[:, 0], None          # (B,d)
    pos = cache["pos"]
    positions = pos[:, None] if pos.dim() else pos.expand(1, 1)
    K = cfg.attn_every
    for g, i, lp in _ssm_layers(p, cfg):
        ssm_c, conv_c = _states(cache, g, i)
        h, x = _add_norm(h, r, lp["ln"], cfg)
        r, st = S.mamba2_step(lp["ssm"], x, {"ssm": ssm_c, "conv": conv_c},
                              cfg)
        ssm_c.copy_(st["ssm"])
        conv_c.copy_(st["conv"])
        if g is not None and i == K - 1:
            h, r, _ = _shared_block(
                p["shared"], h[:, None], r[:, None], cfg, positions,
                kv_cache=(cache["k"][g], cache["v"][g]), cache_pos=pos)
            h, r = h[:, 0], r[:, 0]
    h = _add_norm(h, r, p["ln_f"], cfg)[1][:, None]
    return L.unembed(p, h, cfg)[:, 0], dict(cache, pos=pos + 1)
