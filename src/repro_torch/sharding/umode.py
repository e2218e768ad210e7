"""U-mode training step (port of ``repro/sharding/umode.py::
make_train_step``), single process.

The reference builds one ``jax.jit`` over a mesh whose compiler places
every collective; this port runs on one device, with no mesh and no
gradient accumulation (the port's ``ModelConfig`` carries no
``microbatches``).  Sharded U-mode comes with the LM-sharding slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import api
from repro_torch.models.base import ModelConfig
from repro_torch.train import optim


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the loss
    of ``batch`` ({"tokens", "targets"[, "mask"]}: tensors, or numpy arrays
    moved to the params' device), its gradients over every param by
    ``torch.autograd.grad``, and one in-place AdamW step
    (``optim.adamw_update``).  metrics: {"loss", "grad_norm"} as 0-dim
    tensors and "lr" as a float.  On the card with ``cfg.use_kernels`` the
    gradients flow through the kernels' backward."""
    opt_cfg = opt_cfg or optim.OptConfig()

    def train_step(state, batch):
        params = state["params"]
        flat = optim.leaves(params)
        device = flat[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        for t in flat:
            t.requires_grad_(True)
        try:
            loss = api.loss(params, cfg, batch)
            grads = torch.autograd.grad(loss, flat)
        finally:
            for t in flat:
                t.requires_grad_(False)
        state, metrics = optim.adamw_update(
            state, optim.unflatten(params, grads), opt_cfg)
        return state, {"loss": loss.detach(), **metrics}

    return train_step
