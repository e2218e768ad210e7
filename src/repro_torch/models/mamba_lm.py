"""Mamba2 language model, attention-free (port of
``repro/models/mamba_lm.py``).

mamba2-1.3b: 48 layers, d_model 2048, d_state 128.  Params keep the
reference's keys and stacked layer axis (``{"layers": {"ssm": {...},
"ln": (n, d)}, "ln_f", "embed", "lm_head"}``); the layer loop is Python
where the reference scans.  The serving cache is one SSM state and one
conv tail per layer and slot, with no sequence axis.
"""
from __future__ import annotations

import typing

import torch

from repro_torch import resolve_device

from . import layers as L
from . import ssm as S
from .base import ModelConfig

Params = typing.Dict[str, typing.Any]


def init(seed, cfg: ModelConfig, device="cuda") -> Params:
    """Random params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``).  The draws differ from the reference's ``jax.random``
    ones; parity tests convert the reference's params with
    ``repro_torch.convert.params_from_jax`` instead."""
    device = resolve_device(device)
    gen = L.generator(seed, device)
    n, dt = cfg.num_layers, cfg.torch_dtype
    p: Params = L.init_embed(gen, cfg)
    p["layers"] = {
        "ssm": S.init_mamba2(gen, cfg, n),
        "ln": torch.ones((n, cfg.d_model), dtype=dt, device=device),
    }
    p["ln_f"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return p


def _norm(h, w, cfg: ModelConfig):
    return L.rms_norm(h, w, cfg.norm_eps, use_kernel=cfg.use_kernels)


def _add_norm(h, y, w, cfg: ModelConfig):
    return L.add_rms_norm(h, y, w, cfg.norm_eps, use_kernel=cfg.use_kernels)


# The layer loops carry each block's output ``y`` to the next norm, where
# the residual add h + y runs fused into the norm's launch (the last one
# into ln_f); the values are the reference's h = h + block(norm(h)).

def forward(p: Params, cfg: ModelConfig, tokens):
    """tokens (B,S) int -> (logits (B,S,V) f32, aux 0.0)."""
    h, y = L.embed(p, tokens), None
    for lp in L.layer_slices(p["layers"], cfg.num_layers):
        h, x = _add_norm(h, y, lp["ln"], cfg)
        y = S.mamba2_block(lp["ssm"], x, cfg)
    h = _add_norm(h, y, p["ln_f"], cfg)[1]
    return L.unembed(p, h, cfg), 0.0


def loss_fn(p: Params, cfg: ModelConfig, batch):
    """Mean next-token NLL of ``batch`` ({"tokens", "targets"[, "mask"]})."""
    logits, _ = forward(p, cfg, batch["tokens"])
    return L.cross_entropy(logits, batch["targets"], batch.get("mask"))


# --------------------------------------------------------------------------
# serving: prefill + single-token decode with an O(1) per-slot state
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    """Zero SSM states (n, batch, H, N, P) and conv tails (n, batch, W-1,
    conv_dim), both f32 as in the reference.  ``max_seq`` and ``dtype``
    are taken for the api's sake and not used: the state does not grow
    with the sequence."""
    device = resolve_device(device)
    n = cfg.num_layers
    state = S.init_mamba_state(cfg, n * batch, device)   # per layer and slot
    cache = {k: v.reshape(n, batch, *v.shape[1:]) for k, v in state.items()}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def prefill(p: Params, cfg: ModelConfig, tokens, cache: dict):
    """Run the prompt from a zero state, write each layer's final SSM
    state and conv tail into the cache IN PLACE, and return the logits of
    the last position and the cache with ``pos = S``."""
    h, y = L.embed(p, tokens), None
    for i in range(cfg.num_layers):
        lp = L.layer_slice(p["layers"], i)
        h, x = _add_norm(h, y, lp["ln"], cfg)
        y, st = S.mamba2_block(lp["ssm"], x, cfg, return_state=True)
        cache["ssm"][i] = st["ssm"]
        cache["conv"][i] = st["conv"]
    h = _norm(h[:, -1:] + y[:, -1:], p["ln_f"], cfg)   # the last row only
    pos = torch.tensor(tokens.shape[1], dtype=torch.int32,
                       device=cache["ssm"].device)
    return L.unembed(p, h, cfg)[:, 0], {"ssm": cache["ssm"],
                                        "conv": cache["conv"], "pos": pos}


def decode_step(p: Params, cfg: ModelConfig, cache: dict, token):
    """token (B,) int -> (logits (B,V) f32, cache).  The states are
    updated in place; the returned cache has ``pos + 1``."""
    h, y = L.embed(p, token[:, None])[:, 0], None
    for i in range(cfg.num_layers):
        lp = L.layer_slice(p["layers"], i)
        h, x = _add_norm(h, y, lp["ln"], cfg)
        y, st = S.mamba2_step(lp["ssm"], x, {"ssm": cache["ssm"][i],
                                              "conv": cache["conv"][i]}, cfg)
        cache["ssm"][i] = st["ssm"]
        cache["conv"][i] = st["conv"]
    h = _add_norm(h, y, p["ln_f"], cfg)[1][:, None]
    return L.unembed(p, h, cfg)[:, 0], {"ssm": cache["ssm"],
                                        "conv": cache["conv"],
                                        "pos": cache["pos"] + 1}
