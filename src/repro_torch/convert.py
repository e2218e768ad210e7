"""Parameters across frameworks.

The reference's params are a tree of arrays; ``numpy.asarray`` of each
leaf gives a tree of numpy arrays, and this module turns that into the
port's dict of tensors with the same keys and shapes (the stacked
leading layer axis included).  Parity tests use it to run both
frameworks on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def params_from_jax(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``, each in its leaf's own dtype.

    A bf16 leaf has numpy dtype ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so every leaf goes through float32
    (exact for bf16, f16 and f32) and is then cast back."""
    device = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        dtype = _DTYPES.get(a.dtype.name)
        if dtype is None:
            raise TypeError(f"params_from_jax: unsupported leaf dtype "
                            f"{a.dtype} (float32, bfloat16 or float16)")
        t = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return t.to(device=device, dtype=dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)
