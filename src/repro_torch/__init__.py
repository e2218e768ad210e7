"""PyTorch + CUDA port of the ``repro`` workload layer for NVIDIA Hopper.

Mirrors ``repro``'s module layout one-to-one (``repro/models/layers.py``
-> ``repro_torch/models/layers.py``) and imports nothing of it: the JAX
package is the reference the port is tested against, never a
dependency.  Entry points run on ``device="cuda"`` unless the caller
passes ``device="cpu"``; the hand-written kernels live in
``repro_torch.kernels``.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises rather than running a
    CUDA request on the CPU when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for, but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev
