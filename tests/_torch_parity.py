"""Helpers shared by the tests/test_torch_*.py parity tests: one set of
weights for both frameworks, built by the JAX package and converted."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import api as japi
from repro.models import get_config as jget_config
from repro_torch.convert import params_from_jax

# leaves the reference inits to a constant: base 1 (norm weights, the SSM
# skip D) or base 0 (biases)
_RANDOMISED = {"bq": 0.0, "bk": 0.0, "bv": 0.0, "conv_xb": 0.0,
               "conv_bcb": 0.0, "ln1": 1.0, "ln2": 1.0, "ln3": 1.0,
               "ln_enc": 1.0, "ln_f": 1.0, "ln": 1.0, "norm_w": 1.0,
               "D": 1.0}


def shared_params(arch="qwen2-1.5b-smoke", seed=0):
    """(jax params, torch params on the CPU) of one model.  The reference
    inits biases to 0 and norm weights (and the SSM skip D) to 1, which
    would test nothing, so those leaves are redrawn with numpy before
    converting."""
    cfg = jget_config(arch)
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def redraw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                redraw(v)
            elif k in _RANDOMISED:
                node[k] = (_RANDOMISED[k] + 0.3 * rng.standard_normal(
                    v.shape)).astype(v.dtype)
    redraw(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, params_from_jax(tree, device="cpu")


def spy_norms(monkeypatch):
    """Count the calls of the norm wrappers a model reaches: the wrappers
    in ``repro_torch.kernels.ops`` are patched with counting spies; the
    returned dict fills as they are called."""
    from repro_torch.kernels import ops
    calls = {}
    for name in ("rmsnorm", "add_rmsnorm", "gated_rmsnorm"):
        def spy(*args, _name=name, _real=getattr(ops, name), **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(ops, name, spy)
    return calls


def loss_and_grads(params, cfg, batch):
    """(loss, gradients as a tree like ``params``) of the port's
    ``api.loss``, on a deep copy of ``params``."""
    from repro_torch.models import api
    from repro_torch.train import optim
    p = copy.deepcopy(params)
    flat = optim.leaves(p)
    for t in flat:
        t.requires_grad_(True)
    loss = api.loss(p, cfg, batch)
    return loss.detach(), optim.unflatten(p, torch.autograd.grad(loss, flat))


def assert_leaves_close(got, want, tol):
    """Each leaf of the port's tree ``got`` within tol * the max |value| of
    the same leaf of the JAX tree ``want``."""
    from repro_torch.train import optim
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(optim.leaves(got))
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (path, err, np.abs(w).max())
