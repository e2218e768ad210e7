"""Model configuration + registry (port of ``repro/models/base.py``).

The port keeps its own copy of ``ModelConfig`` so that it never imports
the JAX package.  The architecture fields and derived sizes are the
reference's; what differs:

* ``torch_dtype`` replaces ``jnp_dtype``;
* ``use_kernels`` replaces the reference's unread ``use_pallas``: True
  routes ``rms_norm``, ``attn_impl="flash"`` and the SSM blocks' SSD
  through the hand-written CUDA kernels, False through their plain
  PyTorch versions (the parity oracle the chip smoke compares the kernel
  path with);
* the sharding and training knobs (``remat``, ``scan_layers``,
  ``seq_shard_activations``, ``fsdp``, ``microbatches``) are left out
  until the slices that port sharding and training need them.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int = 0             # 0 for attention-free
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 0
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): shared attention block every k SSM layers ---
    attn_every: int = 0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- VLM (llava) ---
    num_patches: int = 0
    # --- numerics ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # activation/param dtype
    attn_impl: str = "ref"         # "ref" (einsum) | "flash" (CUDA kernel)
    use_kernels: bool = True       # False: plain PyTorch versions instead

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (padded logit columns
        are masked to -1e30 in unembed, so argmax/softmax are exact)."""
        if not self.vocab_size:
            return 0
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def ssm_groups(self) -> int:
        return 1

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def in_proj_dim(self) -> int:
        # z, x, B, C, dt
        return (2 * self.d_inner + 2 * self.ssm_groups * self.ssm_state
                + self.ssm_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (checked against a real init in
        tests/test_torch_models.py)."""
        d, V = self.d_model, self.padded_vocab
        n = 0
        if self.family == "encdec":
            n += V * d + d * V                      # embed + lm head
            n += self.encoder_layers * self._attn_params()
            n += self.encoder_layers * self._mlp_params()
            n += self.encoder_layers * 2 * d        # norms
            n += self.num_layers * (self._attn_params() * 2 +  # self+cross
                                    self._mlp_params() + 3 * d)
            n += 2 * d                              # final norms enc+dec
            return n
        if V:
            n += V * d                              # embed
            if not self.tie_embeddings:
                n += d * V                          # lm_head
        n += d                                      # final norm
        L = self.num_layers
        if self.family in ("dense", "vlm"):
            n += L * (self._attn_params() + self._mlp_params() + 2 * d)
        elif self.family == "moe":
            n += L * (self._attn_params() + self._moe_params() + 2 * d)
        elif self.family == "ssm":
            n += L * (self._ssm_params() + d)
        elif self.family == "hybrid":
            n += L * (self._ssm_params() + d)
            n += self._attn_params() + self._mlp_params() + 2 * d  # shared blk
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        n = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            n += self.q_dim + 2 * self.kv_dim
        return n

    def _mlp_params(self) -> int:
        if self.family == "encdec":                 # gelu 2-matrix MLP
            return 2 * self.d_model * self.d_ff
        return 3 * self.d_model * self.d_ff         # SwiGLU

    def _moe_params(self) -> int:
        return (self.d_model * self.num_experts
                + self.num_experts * 3 * self.d_model * self.d_ff)

    def _ssm_params(self) -> int:
        d = self.d_model
        n = d * self.in_proj_dim                    # in_proj
        n += self.conv_dim * (self.ssm_conv_width + 1)  # conv w + bias
        n += 3 * self.ssm_heads                     # A_log, D, dt_bias
        n += self.d_inner                           # gated norm
        n += self.d_inner * d                       # out_proj
        return n


# --------------------------------------------------------------------------
_REGISTRY: typing.Dict[str, typing.Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> typing.List[str]:
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)
