"""Unified model facade (port of ``repro/models/api.py``) for the dense
family (``transformer``) and the SSM family (``mamba_lm``).  The same
entry points as the reference:

    init(seed, cfg, device)                     -> params
    loss(params, cfg, batch)                    -> scalar f32
    forward(params, cfg, batch)                 -> (logits, aux)
    init_cache(cfg, batch, max_seq, dtype, device) -> cache dict
    prefill(params, cfg, cache, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok)        -> (logits, cache)

``init`` and ``init_cache`` place their tensors on ``device`` ("cuda"
unless the caller asks for the CPU); the others run where their inputs
lie.  The other families (moe, hybrid, encdec, vlm) raise
NotImplementedError until their slices are ported.
"""
from __future__ import annotations

from . import mamba_lm, transformer
from .base import ModelConfig

_FAMILY = {"dense": transformer, "ssm": mamba_lm}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
            f"port has {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def init(seed, cfg: ModelConfig, device="cuda"):
    return module_for(cfg).init(seed, cfg, device=device)


def loss(params, cfg: ModelConfig, batch):
    return module_for(cfg).loss_fn(params, cfg, batch)


def forward(params, cfg: ModelConfig, batch):
    return module_for(cfg).forward(params, cfg, batch["tokens"])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    return module_for(cfg).init_cache(cfg, batch, max_seq, dtype,
                                      device=device)


def prefill(params, cfg: ModelConfig, cache, batch):
    return module_for(cfg).prefill(params, cfg, batch["tokens"], cache)


def decode_step(params, cfg: ModelConfig, cache, token):
    return module_for(cfg).decode_step(params, cfg, cache, token)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
