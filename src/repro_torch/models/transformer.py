"""Decoder-only transformer LM, dense and MoE families (port of
``repro/models/transformer.py``): qwen2-1.5b, qwen1.5-4b, qwen1.5-110b,
internlm2-20b (dense, a SwiGLU MLP a layer) and qwen3-moe-30b-a3b,
dbrx-132b (moe, ``moe.moe_ffn`` in the MLP's place, whose load-balancing
term the loss adds); also the backbone of the VLM family (``vlm.py``,
llava-next-34b: dense, with patch embeddings prepended to the text).

Layer params are stacked on a leading axis, as in the reference; the
forward loops over layers in Python where the reference scans.
"""
from __future__ import annotations

import typing

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device

from . import layers as L
from . import moe as M
from .base import ModelConfig

Params = typing.Dict[str, typing.Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is no "
                         f"decoder-only transformer (dense, moe or vlm)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(seed, cfg: ModelConfig, device="cuda") -> Params:
    """Random params from ``seed`` (an int or a ``torch.Generator`` on
    ``device``): truncated-normal fan-in weights, N(0, 0.02) embedding,
    zero biases, unit norms.  The draws differ from the reference's
    ``jax.random`` ones; parity tests convert the reference's params
    with ``repro_torch.convert.params_from_jax`` instead."""
    _check_family(cfg)
    device = resolve_device(device)
    gen = L.generator(seed, device)
    dt = cfg.torch_dtype
    n = cfg.num_layers
    p: Params = L.init_embed(gen, cfg)
    p["layers"] = {
        "attn": L.init_attention(gen, cfg, n),
        "ln1": torch.ones((n, cfg.d_model), dtype=dt, device=device),
        "ln2": torch.ones((n, cfg.d_model), dtype=dt, device=device),
    }
    if cfg.family == "moe":
        p["layers"]["moe"] = M.init_moe(gen, cfg, n)
    else:
        p["layers"]["mlp"] = L.init_swiglu(gen, cfg, n)
    p["ln_f"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return p


def _add_norm(h, r, w, cfg: ModelConfig):
    return L.add_rms_norm(h, r, w, cfg.norm_eps, use_kernel=cfg.use_kernels)


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------
# The layer loops carry each block's last residual branch ``r`` (the MLP
# or MoE output) to the next norm, where the add h + r runs fused into the
# norm's launch; the last one fuses into ln_f.  The values are the
# reference's h = h + a; h = h + ffn(norm(h)).

def _ffn(lp: Params, x, cfg: ModelConfig):
    """The block's FFN of the normed x (B,S,d): (y, aux), aux the MoE's
    load-balancing term, 0.0 for a dense MLP."""
    if "moe" not in lp:
        return L.swiglu(lp["mlp"], x), 0.0
    B, S, d = x.shape
    y, aux = M.moe_ffn(lp["moe"], x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux


def _layer_fwd(lp: Params, h, r, cfg: ModelConfig, positions):
    """One pre-norm block over the whole sequence, from h and the previous
    block's FFN output r (None before the first block).  Returns (h, this
    block's FFN output, (k, v), aux)."""
    h, x = _add_norm(h, r, lp["ln1"], cfg)
    a, kv = L.attention_block(lp["attn"], x, cfg, positions=positions,
                              causal=True)
    h, x = _add_norm(h, a, lp["ln2"], cfg)
    y, aux = _ffn(lp, x, cfg)
    return h, y, kv, aux


def _hidden(p: Params, cfg: ModelConfig, tokens, extra_embeds=None):
    """Final-normed hidden states (B,S,d), per-layer (k, v) and the sum of
    the layers' aux terms (0.0 for a dense model).  ``extra_embeds``
    (B,P,d), cast to the model's dtype, are prepended to the tokens'
    embeddings: S = P + the tokens' length, positions from 0 at the
    first of them."""
    _check_family(cfg)
    h = L.embed(p, tokens)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    kvs, r, aux = [], None, 0.0
    for lp in L.layer_slices(p["layers"], cfg.num_layers):
        h, r, kv, a = _layer_fwd(lp, h, r, cfg, positions)
        kvs.append(kv)
        aux = aux + a
    # the fused kernel also writes the last h, which nothing reads: one
    # (B, S, d) store, against a launch for an unfused add
    return _add_norm(h, r, p["ln_f"], cfg)[1], kvs, aux


def forward(p: Params, cfg: ModelConfig, tokens, extra_embeds=None):
    """tokens (B,S) int [, extra_embeds (B,P,d) prepended] -> (logits
    (B,P+S,V) f32, aux): aux is the layers' summed MoE load-balancing
    term, 0.0 for a dense model."""
    h, _, aux = _hidden(p, cfg, tokens, extra_embeds)
    return L.unembed(p, h, cfg), aux


# loss_fn takes the chunked cross-entropy from padded_vocab * S on (the
# reference's switch, repro/models/transformer.py:166), in chunks of
# XENT_CHUNK positions
XENT_CHUNK_THRESHOLD = 1 << 26
XENT_CHUNK = 512


def _xent_chunk(p: Params, cfg: ModelConfig, hc, tc, mc):
    """(masked nll sum, mask sum) of one chunk, its logits made here."""
    logits = L.unembed(p, hc, cfg)                  # (B, chunk, Vp) f32
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((logz - gold) * mc), torch.sum(mc)


def _chunked_xent(p: Params, cfg: ModelConfig, h, targets, mask=None,
                  chunk: int = XENT_CHUNK):
    """Cross-entropy without the whole (B, S, Vp) logits (port of
    ``repro/models/transformer.py:127 _chunked_xent``): unembed and
    logsumexp a chunk of positions at a time, each chunk checkpointed, so
    its logits are made again in the backward and no (B, S, Vp) tensor
    lives across the step.  S is padded to a multiple of ``chunk``, the
    padding masked out; the mask defaults to ones in h's dtype."""
    B, S, d = h.shape
    pad = (-S) % chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=h.dtype, device=h.device)
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    nc = (S + pad) // chunk
    parts = [checkpoint(_xent_chunk, p, cfg, hc, tc, mc,
                        use_reentrant=False, preserve_rng_state=False)
             for hc, tc, mc in zip(h.reshape(B, nc, chunk, d).unbind(1),
                                   targets.reshape(B, nc, chunk).unbind(1),
                                   mask.reshape(B, nc, chunk).unbind(1))]
    nlls, counts = (torch.stack(t) for t in zip(*parts))
    return torch.sum(nlls) / torch.clamp(torch.sum(counts), min=1)


def loss_fn(p: Params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Mean next-token NLL of ``batch`` ({"tokens", "targets"[, "mask",
    "patches"]}); chunked (``_chunked_xent``) once ``padded_vocab * S``
    reaches ``XENT_CHUNK_THRESHOLD``.  With "patches" (the VLM) they are
    prepended and the loss is taken on the text positions only, the
    chunking switch on their count.  A MoE model adds ``aux_weight`` times
    its load-balancing term; the others add nothing."""
    tgt = batch["targets"]
    h, _, aux = _hidden(p, cfg, batch["tokens"], batch.get("patches"))
    if h.shape[1] != tgt.shape[1]:              # VLM: the text positions
        h = h[:, -tgt.shape[1]:]
    if cfg.padded_vocab * h.shape[1] >= XENT_CHUNK_THRESHOLD:
        nll = _chunked_xent(p, cfg, h, tgt, batch.get("mask"), XENT_CHUNK)
    else:
        logits = L.unembed(p, h, cfg)
        nll = L.cross_entropy(logits, tgt, batch.get("mask"))
    return nll + aux_weight * aux if cfg.family == "moe" else nll


# --------------------------------------------------------------------------
# serving: prefill + single-token decode with static KV cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda") -> dict:
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(p: Params, cfg: ModelConfig, tokens, cache: dict,
            extra_embeds=None):
    """Run the prompt (``extra_embeds`` prepended, as in ``_hidden``),
    fill the cache IN PLACE (rows [0, S), S counting the extra rows),
    return the logits of the last position and the cache with
    ``pos = S``."""
    h, kvs, _ = _hidden(p, cfg, tokens, extra_embeds)
    S = h.shape[1]
    for i, (k, v) in enumerate(kvs):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    logits = L.unembed(p, h[:, -1:], cfg)[:, 0]
    pos = torch.tensor(S, dtype=torch.int32, device=cache["k"].device)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos}


def decode_step(p: Params, cfg: ModelConfig, cache: dict, token):
    """token (B,) int -> (logits (B,V) f32, cache).  One new token per
    row attending to a KV cache of static length; ``cache["pos"]`` is a
    scalar or (B,) per-slot positions.  The cache's k/v are updated in
    place; the returned cache has ``pos + 1``."""
    _check_family(cfg)
    B = token.shape[0]
    h = L.embed(p, token[:, None])                     # (B,1,d)
    pos = cache["pos"]
    positions = pos[:, None] if pos.dim() else pos.expand(1, 1)
    r = None
    for i in range(cfg.num_layers):
        lp = L.layer_slice(p["layers"], i)
        h, x = _add_norm(h, r, lp["ln1"], cfg)
        a, _ = L.attention_block(
            lp["attn"], x, cfg, positions=positions, causal=False,
            kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
        h, x = _add_norm(h, a, lp["ln2"], cfg)
        r = _ffn(lp, x, cfg)[0]
    h = _add_norm(h, r, p["ln_f"], cfg)[1]
    logits = L.unembed(p, h, cfg)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
