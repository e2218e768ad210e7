"""Unified model facade (port of ``repro/models/api.py``) for all six
families of the reference: dense and MoE (``transformer``), VLM
(``vlm``), enc-dec (``encdec``), SSM (``mamba_lm``) and hybrid
(``hybrid``).  The same entry points as the reference:

    init(seed, cfg, device)                     -> params
    loss(params, cfg, batch)                    -> scalar f32
    forward(params, cfg, batch)                 -> (logits, aux)
    init_cache(cfg, batch, max_seq, dtype, device) -> cache dict
    prefill(params, cfg, cache, batch)          -> (last_logits, cache)
    decode_step(params, cfg, cache, tok)        -> (logits, cache)

``batch`` carries the modality stubs under the reference's keys:
"frames" (the enc-dec's audio frames, (B, encoder_seq, d)) and
"patches" (the VLM's image patches, (B, num_patches, d)).  ``init`` and
``init_cache`` place their tensors on ``device`` ("cuda" unless the
caller asks for the CPU); the others run where their inputs lie.
"""
from __future__ import annotations

from . import encdec, hybrid, mamba_lm, moe, transformer, vlm
from .base import ModelConfig

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": vlm,
           "encdec": encdec, "ssm": mamba_lm, "hybrid": hybrid}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"families are {sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def init(seed, cfg: ModelConfig, device="cuda"):
    return module_for(cfg).init(seed, cfg, device=device)


def loss(params, cfg: ModelConfig, batch):
    return module_for(cfg).loss_fn(params, cfg, batch)


# family -> the batch key of the modality stub its forward and prefill
# take after the tokens
STUB_KEYS = {"encdec": "frames", "vlm": "patches"}


def _extra(cfg: ModelConfig, batch) -> tuple:
    key = STUB_KEYS.get(cfg.family)
    return () if key is None else (batch[key],)


def forward(params, cfg: ModelConfig, batch):
    return module_for(cfg).forward(params, cfg, batch["tokens"],
                                   *_extra(cfg, batch))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device="cuda"):
    return module_for(cfg).init_cache(cfg, batch, max_seq, dtype,
                                      device=device)


def prefill(params, cfg: ModelConfig, cache, batch):
    return module_for(cfg).prefill(params, cfg, batch["tokens"], cache,
                                   *_extra(cfg, batch))


def decode_step(params, cfg: ModelConfig, cache, token):
    return module_for(cfg).decode_step(params, cfg, cache, token)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def train_step_matmul_flops(cfg: ModelConfig, batch: int, seq: int) -> int:
    """FLOPs of the matrix products (aten ``mm``/``bmm``, not the
    kernels') of one train step of ``cfg`` at ``batch`` x ``seq`` tokens:
    each forward product and its two backward ones (dX and dW).  This is
    the count ``core.hlo.matmul_flops`` of a traced step must equal.
    ``seq`` is the tokens' length: a VLM's layers run over
    ``num_patches`` more positions, an enc-dec's encoder over
    ``encoder_seq`` frames.

    Per layer: the projections and the MLP, or the MoE's f32 router and
    its experts over every one of the E x C capacity slots (dump slots
    included, grouped capacities where ``moe.moe_ffn`` groups); the
    materialised QK^T and P V where attention is not the flash kernel
    (``attn_impl="ref"``); an SSM layer's in and out projections and the
    SSD's carry-in term ``y_off`` (over the chunk-padded sequence; with
    two chunks or more, so that its state input takes a gradient); an
    enc-dec's encoder layers over the frames, and its decoder layers'
    self-attention, cross-attention (q and out projections over the
    tokens, k and v over the encoder states, QK^T and P V over tokens x
    frames where not flash) and two-matrix gelu MLP.  Then the
    unembedding over the text positions, done once more in the backward
    where the chunked loss recomputes each chunk's logits (on the
    sequence padded to ``transformer.XENT_CHUNK``)."""
    B, S, d, T = batch, seq, cfg.d_model, batch * seq
    Vp = cfg.padded_vocab
    proj = d * (2 * cfg.q_dim + 2 * cfg.kv_dim)

    def core(sq: int, skv: int) -> int:
        return (0 if cfg.attn_impl == "flash" else
                2 * 2 * B * cfg.num_heads * sq * skv * cfg.hd)
    if cfg.family == "encdec":
        Te = cfg.encoder_seq
        mlp = 2 * d * cfg.d_ff
        enc_layer = 2 * B * Te * (proj + mlp) + core(Te, Te)
        dec_layer = (2 * T * (proj + mlp) + core(S, S)
                     + 2 * T * 2 * d * cfg.q_dim
                     + 2 * B * Te * 2 * d * cfg.kv_dim + core(S, Te))
        return 3 * (cfg.encoder_layers * enc_layer
                    + cfg.num_layers * dec_layer + 2 * T * d * Vp)
    S_all = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    attn_block = 2 * B * S_all * (proj + 3 * d * cfg.d_ff) + core(S_all,
                                                                   S_all)
    if cfg.family in ("ssm", "hybrid"):
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        Q = min(cfg.ssm_chunk, S)
        if -(-S // Q) < 2:
            raise ValueError(f"{S} tokens make one SSD chunk of {Q}: y_off's "
                             f"state input takes no gradient")
        Lp = -(-S // Q) * Q
        ssm_layer = (2 * T * d * (2 * cfg.d_inner + 2 * cfg.ssm_groups * N
                                  + H + cfg.d_inner)
                     + 2 * B * Lp * H * N * P)
        fwd = cfg.num_layers * ssm_layer + 2 * T * d * Vp
        if cfg.family == "hybrid":
            fwd += hybrid._gr(cfg)[0] * attn_block
        return 3 * fwd
    if cfg.family == "moe":
        E, Gr = cfg.num_experts, cfg.moe_groups
        slots = (E * Gr * moe.capacity(T // Gr, cfg)
                 if Gr > 1 and T % Gr == 0 else E * moe.capacity(T, cfg))
        layer = (2 * T * (proj + d * E) + core(S, S)
                 + 2 * slots * 3 * d * cfg.d_ff)
    else:
        layer = attn_block
    fwd = cfg.num_layers * layer
    if Vp * S >= transformer.XENT_CHUNK_THRESHOLD:
        Sp = -(-S // transformer.XENT_CHUNK) * transformer.XENT_CHUNK
        return 3 * fwd + 4 * 2 * B * Sp * d * Vp
    return 3 * (fwd + 2 * T * d * Vp)
