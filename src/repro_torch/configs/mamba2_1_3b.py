"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]

Widths as in ``repro/configs/mamba2_1_3b.py``; the reference's
``microbatches`` (a training knob) is not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("mamba2-1.3b")
def mamba2_1_3b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50_280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    )


@register("mamba2-1.3b-smoke")
def mamba2_1_3b_smoke() -> ModelConfig:
    return mamba2_1_3b().replace(
        name="mamba2-1.3b-smoke", num_layers=2, d_model=64, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=8, vocab_size=256, dtype="float32")
