"""Hand-written Hopper kernels for the port's hot spots.

Kernels (each with a plain PyTorch version in ref.py, public wrapper and
launch counter in ops.py, CUDA source in csrc/, launcher module of the
kernel's name, built by build.py at first use):
  * flash_attention — causal GQA attention (models' attn_impl="flash")
  * rmsnorm         — fused normalisation (every rms_norm of the models)
  * ssd             — Mamba2 intra-chunk SSD (``ops.ssd_chunk_kernel``,
                      under ``ops.ssd_chunked`` in every SSM prefill)

The wrappers are not re-exported here, so that ``kernels.rmsnorm``,
``kernels.flash_attention`` and ``kernels.ssd`` stay the launcher
modules.  The TPU kernels stencil and bitonic are ported in later
slices.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
