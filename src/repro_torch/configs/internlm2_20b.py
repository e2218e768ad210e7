"""internlm2-20b [dense] — GQA. [arXiv:2403.17297; hf]

Widths as in ``repro/configs/internlm2_20b.py``.  The full config
selects ``attn_impl="flash"`` (the hand-written CUDA kernel; hd = 6144 /
48 = 128) where the reference selects "ref": for causal self-attention
of equal query and key lengths, the only call ``attention_core`` routes
to flash, the two compute the same function.  The reference's sharding
and training knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("internlm2-20b")
def internlm2_20b() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16_384, vocab_size=92_544,
        rope_theta=1e6, attn_impl="flash",
    )


@register("internlm2-20b-smoke")
def internlm2_20b_smoke() -> ModelConfig:
    return internlm2_20b().replace(
        name="internlm2-20b-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
        attn_impl="ref")
