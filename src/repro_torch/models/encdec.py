"""Whisper-style encoder-decoder transformer (port of
``repro/models/encdec.py``): whisper-base.

The conv audio frontend is a stub, as in the reference: the batch brings
precomputed frame embeddings (B, T_enc, d_model).  A bidirectional
encoder and a causal decoder with cross-attention, sinusoidal positions
for both stacks, a two-matrix gelu MLP a layer.  The param tree keeps
the reference's layout: "encoder" {attn, mlp, ln1, ln2} and "decoder"
{self_attn, cross_attn, mlp, ln1, ln2, ln3} stacked on a leading layer
axis, then ln_enc and ln_f.  The cache holds the decoder's self-attention
k/v (L, B, max_seq, K, hd) and the cross-attention's k/v over the
encoder states (L, B, encoder_seq, K, hd), written once at prefill.

The loops are Python where the reference scans.  With ``attn_impl=
"flash"`` the encoder's attention and every cross-attention run the
flash kernel non-causal (at decode, one query row against the encoder's
1500), the decoder's self-attention causal at train and prefill; decode
self-attention is the einsum over the cache, as in every family.  On the
kernel path each residual add is fused into the next norm's launch
(h + a into ln2, h + c into ln3, h + mlp into the next layer's ln1, or
into ln_enc / ln_f), where the reference adds and then normalises: the
values are the reference's.
"""
from __future__ import annotations

import typing

import torch

from repro_torch import resolve_device

from . import layers as L
from .base import ModelConfig

Params = typing.Dict[str, typing.Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is no "
                         f"encoder-decoder")


def init(seed, cfg: ModelConfig, device="cuda") -> Params:
    """Random params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``): truncated-normal fan-in weights, N(0, 0.02) embedding,
    unit norms.  The draws differ from the reference's ``jax.random``
    ones; parity tests convert the reference's params with
    ``repro_torch.convert.params_from_jax`` instead."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(seed, device)
    ne, nd, d = cfg.encoder_layers, cfg.num_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.torch_dtype, device=device)
    p: Params = L.init_embed(gen, cfg)
    p["encoder"] = {"attn": L.init_attention(gen, cfg, ne),
                    "mlp": L.init_gelu_mlp(gen, cfg, ne),
                    "ln1": ones(ne, d), "ln2": ones(ne, d)}
    p["decoder"] = {"self_attn": L.init_attention(gen, cfg, nd),
                    "cross_attn": L.init_attention(gen, cfg, nd),
                    "mlp": L.init_gelu_mlp(gen, cfg, nd),
                    "ln1": ones(nd, d), "ln2": ones(nd, d),
                    "ln3": ones(nd, d)}
    p["ln_enc"] = ones(d)
    p["ln_f"] = ones(d)
    return p


def _add_norm(h, r, w, cfg: ModelConfig):
    return L.add_rms_norm(h, r, w, cfg.norm_eps, use_kernel=cfg.use_kernels)


def encode(p: Params, cfg: ModelConfig, frames):
    """frames (B, T_enc, d) stub embeddings (any float dtype, cast to the
    model's) -> the encoder states (B, T_enc, d), ln_enc applied."""
    _check_family(cfg)
    B, T, d = frames.shape
    dt = cfg.torch_dtype
    h = frames.to(dt) + L.sinusoidal_pos(T, d, dt, frames.device)
    r = None
    for lp in L.layer_slices(p["encoder"], cfg.encoder_layers):
        h, x = _add_norm(h, r, lp["ln1"], cfg)
        a, _ = L.attention_block(lp["attn"], x, cfg, causal=False)
        h, x = _add_norm(h, a, lp["ln2"], cfg)
        r = L.gelu_mlp(lp["mlp"], x)
    return _add_norm(h, r, p["ln_enc"], cfg)[1]


def _cross_kv(lp: Params, enc, cfg: ModelConfig):
    """The cross-attention's k, v (B, T_enc, K, hd) of the encoder states."""
    B, T, _ = enc.shape
    k, v = enc @ lp["wk"], enc @ lp["wv"]
    if "bk" in lp:
        k, v = k + lp["bk"], v + lp["bv"]
    return (k.reshape(B, T, cfg.num_kv_heads, cfg.hd),
            v.reshape(B, T, cfg.num_kv_heads, cfg.hd))


def _decoder(p: Params, cfg: ModelConfig, tokens, enc, cache=None):
    """The decoder over the whole prompt: (h, the last MLP output r)
    before ln_f.  With ``cache``, each layer's self-attention k/v go
    into rows [0, S) and its cross k/v over the encoder into xk/xv, IN
    PLACE."""
    B, S = tokens.shape
    dt = cfg.torch_dtype
    h = L.embed(p, tokens) + L.sinusoidal_pos(S, cfg.d_model, dt,
                                              tokens.device)
    r = None
    for i, lp in enumerate(L.layer_slices(p["decoder"], cfg.num_layers)):
        h, x = _add_norm(h, r, lp["ln1"], cfg)
        a, (k, v) = L.attention_block(lp["self_attn"], x, cfg, causal=True)
        h, x = _add_norm(h, a, lp["ln2"], cfg)
        xk, xv = _cross_kv(lp["cross_attn"], enc, cfg)
        c, _ = L.attention_block(lp["cross_attn"], x, cfg,
                                 kv_override=(xk, xv))
        h, x = _add_norm(h, c, lp["ln3"], cfg)
        r = L.gelu_mlp(lp["mlp"], x)
        if cache is not None:
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            cache["xk"][i] = xk
            cache["xv"][i] = xv
    return h, r


def decode(p: Params, cfg: ModelConfig, tokens, enc):
    """Teacher-forced decoder pass. tokens (B,S) -> logits (B,S,V) f32."""
    _check_family(cfg)
    h, r = _decoder(p, cfg, tokens, enc)
    return L.unembed(p, _add_norm(h, r, p["ln_f"], cfg)[1], cfg)


def forward(p: Params, cfg: ModelConfig, tokens, frames):
    """tokens (B,S) int, frames (B,T_enc,d) -> (logits (B,S,V) f32, 0.0)."""
    return decode(p, cfg, tokens, encode(p, cfg, frames)), 0.0


def loss_fn(p: Params, cfg: ModelConfig, batch):
    """Mean next-token NLL of ``batch`` ({"tokens", "targets", "frames"
    [, "mask"]})."""
    logits, _ = forward(p, cfg, batch["tokens"], batch["frames"])
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """Zero self-attention k/v (L, batch, max_seq, K, hd) and cross k/v
    (L, batch, encoder_seq, K, hd) in ``dtype`` (the model's by
    default), and a scalar ``pos``."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    kv = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    xkv = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(p: Params, cfg: ModelConfig, tokens, cache: dict, frames=None):
    """Encode the frames, fill the cross k/v and the prompt's
    self-attention k/v rows [0, S) IN PLACE, and return the logits of the
    last position and the cache with ``pos = S``."""
    enc = encode(p, cfg, frames)
    if enc.shape[1] != cache["xk"].shape[2]:
        raise ValueError(f"{cfg.name}: {enc.shape[1]} frames, the cache "
                         f"holds cross k/v over {cache['xk'].shape[2]}")
    h, r = _decoder(p, cfg, tokens, enc, cache)
    # the fused norm runs over every row, as the transformer's ln_f does
    h = _add_norm(h, r, p["ln_f"], cfg)[1]
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32,
                       device=cache["k"].device)
    return L.unembed(p, h[:, -1:], cfg)[:, 0], dict(cache, pos=pos)


def decode_step(p: Params, cfg: ModelConfig, cache: dict, token):
    """token (B,) int -> (logits (B,V) f32, cache).  One new token per
    row at ``cache["pos"]``, whose sinusoidal position is taken at most
    at the cache's last row (the reference's ``dynamic_slice`` clamps).
    The self-attention k/v are updated in place; the returned cache has
    ``pos + 1``."""
    _check_family(cfg)
    pos = cache["pos"]
    S_max = cache["k"].shape[2]
    pe = L.sinusoidal_pos(0, cfg.d_model, cfg.torch_dtype,
                          positions=pos.reshape(-1).clamp(0, S_max - 1))
    h, r = L.embed(p, token[:, None]) + pe[:, None], None      # (B,1,d)
    for i, lp in enumerate(L.layer_slices(p["decoder"], cfg.num_layers)):
        h, x = _add_norm(h, r, lp["ln1"], cfg)
        a, _ = L.attention_block(
            lp["self_attn"], x, cfg, causal=False,
            kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        h, x = _add_norm(h, a, lp["ln2"], cfg)
        c, _ = L.attention_block(lp["cross_attn"], x, cfg,
                                 kv_override=(cache["xk"][i],
                                              cache["xv"][i]))
        h, x = _add_norm(h, c, lp["ln3"], cfg)
        r = L.gelu_mlp(lp["mlp"], x)
    h = _add_norm(h, r, p["ln_f"], cfg)[1]
    return L.unembed(p, h, cfg)[:, 0], dict(cache, pos=pos + 1)
