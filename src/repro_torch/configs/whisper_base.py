"""whisper-base [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356]

Widths as in ``repro/configs/whisper_base.py``: precomputed frame
embeddings (B, 1500, 512) stand in for the conv1d + mel frontend.  The
full config selects ``attn_impl="flash"`` (the hand-written CUDA kernel;
hd = 512 / 8 = 64) where the reference selects "ref": the encoder's and
the cross-attention's non-causal calls, and the decoder's causal
self-attention over equal query and key lengths, compute the same
function on either.  The smoke keeps "ref", as the reference's does.
The reference's sharding and training knobs are not carried.
"""
from repro_torch.models.base import ModelConfig, register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, encoder_layers=6, d_model=512, num_heads=8,
        num_kv_heads=8, d_ff=2048, vocab_size=51_865,
        encoder_seq=1500, attn_impl="flash",
    )


@register("whisper-base-smoke")
def whisper_base_smoke() -> ModelConfig:
    return whisper_base().replace(
        name="whisper-base-smoke", num_layers=2, encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        encoder_seq=16, dtype="float32", attn_impl="ref")
