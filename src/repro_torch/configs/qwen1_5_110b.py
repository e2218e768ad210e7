"""qwen1.5-110b [dense] — GQA kv=8, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

Widths as in ``repro/configs/qwen1_5_110b.py``.  The full config selects
``attn_impl="flash"`` (the hand-written CUDA kernel; hd = 8192 / 64 =
128) where the reference selects "ref": for causal self-attention of
equal query and key lengths, the only call ``attention_core`` routes to
flash, the two compute the same function.  The smoke keeps "ref" (the
reference's smoke inherits it).  Its 222 GB of bf16 weights fit no one
card: the port traces it on ``meta``.
"""
from repro_torch.models.base import ModelConfig, register


@register("qwen1.5-110b")
def qwen1_5_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=49_152, vocab_size=152_064, qkv_bias=True, attn_impl="flash",
    )


@register("qwen1.5-110b-smoke")
def qwen1_5_110b_smoke() -> ModelConfig:
    return qwen1_5_110b().replace(
        name="qwen1.5-110b-smoke", num_layers=3, d_model=64, num_heads=8,
        num_kv_heads=2, d_ff=256, vocab_size=256, dtype="float32",
        attn_impl="ref")
