"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]

Widths as in ``repro/configs/dbrx_132b.py``, ``attn_impl`` included
("ref").  Its 263 GB of bf16 weights fit no one card: the port traces it
on ``meta``.  The reference's sharding and training knobs are not
carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10_752, vocab_size=100_352,
        num_experts=16, experts_per_token=4, moe_groups=256,
        rope_theta=5e5, attn_impl="ref",
    )


@register("dbrx-132b-smoke")
def dbrx_132b_smoke() -> ModelConfig:
    return dbrx_132b().replace(
        name="dbrx-132b-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, d_ff=96, vocab_size=256, num_experts=4,
        experts_per_token=2, capacity_factor=4.0, moe_groups=4,
        dtype="float32")
