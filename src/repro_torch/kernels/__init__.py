"""Hand-written Hopper kernels for the port's hot spots.

Kernels (each with a plain PyTorch version in ref.py, public wrapper and
launch counter in ops.py, CUDA source in csrc/, launcher module of the
kernel's name, built by build.py at first use):
  * flash_attention — causal GQA attention (models' attn_impl="flash")
  * rmsnorm         — fused normalisation (every rms_norm of the models)

The wrappers are not re-exported here, so that ``kernels.rmsnorm`` and
``kernels.flash_attention`` stay the launcher modules.  The TPU kernels
ssd, stencil and bitonic are ported in later slices.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
