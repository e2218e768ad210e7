"""qwen2-1.5b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]

Widths as in ``repro/configs/qwen2_1_5b.py``.  The full config selects
``attn_impl="flash"`` (the hand-written CUDA kernel) where the reference
selects "blocked", a q-chunked memory trick that computes the same
function; the reference's sharding knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("qwen2-1.5b")
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151_936, qkv_bias=True,
        rope_theta=1e6, attn_impl="flash",
    )


@register("qwen2-1.5b-smoke")
def qwen2_1_5b_smoke() -> ModelConfig:
    return qwen2_1_5b().replace(
        name="qwen2-1.5b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        attn_impl="ref")
