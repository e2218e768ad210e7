"""Hand-written Hopper kernels for the port's hot spots.

Kernels (each with a plain PyTorch version in ref.py, public wrapper and
launch counter in ops.py, CUDA source in csrc/, launcher module of the
kernel's name, built by build.py at first use):
  * flash_attention — causal GQA attention (models' attn_impl="flash"),
                      and its backward (``ops.flash_attention_bwd``,
                      source csrc/flash_attention_bwd.cu)
  * rmsnorm         — fused normalisation (every rms_norm of the models),
                      and its backward (``ops.rmsnorm_bwd``,
                      ``ops.add_rmsnorm_bwd``)
  * ssd             — Mamba2 intra-chunk SSD (``ops.ssd_chunk_kernel``,
                      under ``ops.ssd_chunked`` in every SSM prefill)
  * stencil         — K x K 2-D stencil (``ops.stencil2d``, MGMark SC)
  * bitonic         — one bitonic compare-exchange stage
                      (``ops.bitonic_stage``, MGMark BS)

The wrappers are not re-exported here, so that ``kernels.rmsnorm``,
``kernels.flash_attention``, ``kernels.ssd``, ``kernels.stencil`` and
``kernels.bitonic`` stay the launcher modules.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
