"""llava-next-34b [vlm] — anyres tiling STUB + dense 60L backbone.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Widths as in ``repro/configs/llava_next_34b.py``: precomputed patch
embeddings (B, 2880, d_model) stand in for the vision tower and its
projector (anyres: 4 tiles + base image, 576 CLIP patches each).  The
full config selects ``attn_impl="flash"`` (the hand-written CUDA kernel;
hd = 7168 / 56 = 128) where the reference selects "ref": for causal
self-attention of equal query and key lengths, the only call the
backbone makes outside decode, the two compute the same function.  The
smoke keeps "ref", as the reference's does.  The reference's sharding
and training knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("llava-next-34b")
def llava_next_34b() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=20_480, vocab_size=64_000,
        num_patches=2880, rope_theta=5e6, attn_impl="flash",
    )


@register("llava-next-34b-smoke")
def llava_next_34b_smoke() -> ModelConfig:
    return llava_next_34b().replace(
        name="llava-next-34b-smoke", num_layers=2, d_model=64, num_heads=8,
        num_kv_heads=2, d_ff=128, vocab_size=256, num_patches=8,
        dtype="float32", attn_impl="ref")
