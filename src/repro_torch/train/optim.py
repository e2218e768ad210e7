"""Optimizer substrate (port of ``repro/train/optim.py``): AdamW + grad
clipping + LR schedules + TrainState, over nested dicts of tensors.

As in the reference, Adam moments are f32 whatever the params' dtype
(bf16 params and grads, f32 optimizer state), gradients are clipped by
their global norm in f32 and cast back to their dtype, and decoupled
weight decay applies to leaves with ``ndim >= 2``.  The port stacks layer
params on a leading axis as the reference does, so the stacked norm
weights (L, d) and QKV biases are decayed too, as there.
``torch.optim.AdamW`` would keep bf16 moments for bf16 params and decay
every leaf, so it is not used.

Unlike the reference's pure functions, ``adamw_update`` updates the
state's params and moments IN PLACE (under ``torch.no_grad()``) and
returns the same state dict: a step then needs no second copy of the
params and moments.  The step count is a Python int.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: typing.Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # "cosine" | "constant" | "linear"


def lr_at(cfg: OptConfig, step) -> float:
    """The reference's schedule, in its f32 arithmetic (numpy float32):
    linear warmup over ``warmup_steps``, then cosine, linear or constant
    decay to ``total_steps``."""
    f = np.float32
    step = f(step)
    warm = np.minimum(f(1.0), (step + f(1)) / f(max(1, cfg.warmup_steps)))
    if cfg.schedule == "constant":
        decay = f(1.0)
    else:
        frac = np.clip((step - f(cfg.warmup_steps))
                       / f(max(1, cfg.total_steps - cfg.warmup_steps)),
                       f(0.0), f(1.0))
        decay = (f(1.0) - frac) if cfg.schedule == "linear" else \
            f(0.5) * (f(1.0) + np.cos(f(np.pi) * frac))
    return float(f(cfg.lr) * warm * decay)


def leaves(tree) -> typing.List[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (``jax.tree``'s),
    so that two trees with the same keys line up whatever their insertion
    order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: typing.Sequence[torch.Tensor]):
    """A nested dict shaped as ``like`` holding ``flat`` in the order of
    ``leaves(like)``."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_state(params) -> dict:
    """TrainState: {params, mu, nu, step}; moments f32 zeros."""
    zeros32 = (lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
    return {"params": params, "mu": tree_map(zeros32, params),
            "nu": tree_map(zeros32, params), "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-dim tensor)."""
    return torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32).square()
        for g in leaves(tree)]).sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled in f32 to a global norm of at most ``max_norm`` and
    cast back to their dtypes, the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(state: dict, grads, cfg: OptConfig):
    """One AdamW step, in place.  Returns (state, {"grad_norm", "lr"}):
    grad_norm a 0-dim f32 tensor (before clipping), lr a float."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas
    f = np.float32
    bc1 = float(f(1.0) - f(b1) ** f(step))
    bc2 = float(f(1.0) - f(b2) ** f(step))
    for p, g, m, v in zip(leaves(state["params"]), leaves(grads),
                          leaves(state["mu"]), leaves(state["nu"])):
        # clipped in f32 and cast back to g's dtype, as the reference's
        # clip_by_global_norm hands them to the update
        g32 = (g.float() * scale).to(g.dtype).float()
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        delta = (m / bc1) / ((v / bc2).sqrt_() + cfg.eps)
        if p.dim() >= 2:                      # decoupled WD on matrices only
            delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return state, {"grad_norm": gnorm, "lr": lr}
