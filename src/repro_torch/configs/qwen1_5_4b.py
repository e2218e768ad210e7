"""qwen1.5-4b [dense] — MHA (kv=heads), QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

Widths as in ``repro/configs/qwen1_5_4b.py``.  The full config selects
``attn_impl="flash"`` (the hand-written CUDA kernel; hd = 2560 / 20 =
128) where the reference selects "blocked", a q-chunked memory trick
that computes the same function for the causal self-attention of equal
query and key lengths, the only call ``attention_core`` routes to
flash; the reference's sharding knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("qwen1.5-4b")
def qwen1_5_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
        d_ff=6912, vocab_size=151_936, qkv_bias=True, attn_impl="flash",
    )


@register("qwen1.5-4b-smoke")
def qwen1_5_4b_smoke() -> ModelConfig:
    return qwen1_5_4b().replace(
        name="qwen1.5-4b-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, dtype="float32",
        attn_impl="ref")
