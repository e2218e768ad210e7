"""Helpers shared by the tests/test_torch_*.py parity tests: one set of
weights for both frameworks, built by the JAX package and converted."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import api as japi
from repro.models import get_config as jget_config
from repro_torch.convert import params_from_jax

_RANDOMISED = {"bq", "bk", "bv", "ln1", "ln2", "ln_f"}


def shared_params(arch="qwen2-1.5b-smoke", seed=0):
    """(jax params, torch params on the CPU) of one model.  The reference
    inits the qkv biases to 0 and the norm weights to 1, which would test
    nothing, so those leaves are redrawn with numpy before converting."""
    cfg = jget_config(arch)
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def redraw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                redraw(v)
            elif k in _RANDOMISED:
                base = 1.0 if k.startswith("ln") else 0.0
                node[k] = (base + 0.3 * rng.standard_normal(v.shape)
                           ).astype(v.dtype)
    redraw(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, params_from_jax(tree, device="cpu")
