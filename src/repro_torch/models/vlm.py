"""LLaVA-NeXT-style VLM (port of ``repro/models/vlm.py``): an anyres patch
frontend (STUB) and the dense transformer backbone.

As in the reference, the batch brings precomputed patch embeddings
(B, num_patches, d_model) -- the anyres tiling (4 tiles + 1 base image,
576 patches each = 2880) is represented by the patch count only.  The
backbone (llava-next-34b: 60 layers, d = 7168) is ``transformer``'s;
the patches are prepended to the text tokens and the loss applies to
the text positions.
"""
from __future__ import annotations

from . import transformer as T
from .base import ModelConfig

init = T.init
init_cache = T.init_cache


def forward(p, cfg: ModelConfig, tokens, patches):
    return T.forward(p, cfg, tokens, extra_embeds=patches)


def loss_fn(p, cfg: ModelConfig, batch):
    return T.loss_fn(p, cfg, batch)


def prefill(p, cfg: ModelConfig, tokens, cache, patches=None):
    return T.prefill(p, cfg, tokens, cache, extra_embeds=patches)


decode_step = T.decode_step
