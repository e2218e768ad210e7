"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

81 SSM layers; the single shared attention+MLP block runs after every
6th SSM layer (13 applications + 3 tail SSM layers). MHA kv=32.

Widths as in ``repro/configs/zamba2_7b.py``.  Its head dim, 3584 / 32 =
112, is not one the flash kernel is built for
(``kernels/flash_attention.py::HEAD_DIMS``), so the full config keeps the
reference's ``attn_impl="ref"``.  The reference's sharding and training
knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14_336, vocab_size=32_000,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64,
        attn_every=6, attn_impl="ref",
    )


@register("zamba2-7b-smoke")
def zamba2_7b_smoke() -> ModelConfig:
    return zamba2_7b().replace(
        name="zamba2-7b-smoke", num_layers=5, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, attn_every=2, dtype="float32")
