"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Qwen3 uses an explicit head_dim=128 (num_heads*head_dim != d_model).
d_ff=768 is the per-expert intermediate size.

Widths as in ``repro/configs/qwen3_moe_30b.py``.  The full config
selects ``attn_impl="flash"`` (the hand-written CUDA kernel; hd = 128,
H = 32, K = 4) where the reference selects "ref": for causal
self-attention of equal query and key lengths, the only call
``attention_core`` routes to flash, the two compute the same function.
The reference's sharding and training knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        head_dim=128, d_ff=768, vocab_size=151_936,
        num_experts=128, experts_per_token=8, moe_groups=256,
        rope_theta=1e6, attn_impl="flash",
    )


@register("qwen3-moe-30b-a3b-smoke")
def qwen3_moe_30b_smoke() -> ModelConfig:
    return qwen3_moe_30b().replace(
        name="qwen3-moe-30b-a3b-smoke", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        num_experts=8, experts_per_token=2, capacity_factor=8.0,
        moe_groups=4, dtype="float32", attn_impl="ref")
