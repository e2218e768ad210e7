"""repro_torch.convert (JAX param trees -> torch) and the port's package
rules: no JAX and nothing of the JAX package, nothing built at import."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def test_bf16_leaves_convert_exactly():
    x = np.random.default_rng(0).standard_normal((3, 7)).astype(
        ml_dtypes.bfloat16)
    got = params_from_jax({"w": x}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), x.astype(np.float32))


@pytest.mark.parametrize("arch", ["qwen2-1.5b-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_keys_shapes_and_values_preserved(arch, dtype):
    cfg = jget_config(arch).replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(1), cfg))
    got = params_from_jax(tree, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_j) == len(jax.tree.leaves(got))
    for path, leaf in flat_j:
        t = got
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_unsupported_leaf_dtype_raises():
    with pytest.raises(TypeError, match="int32"):
        params_from_jax({"ids": np.arange(3, dtype=np.int32)}, device="cpu")


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": jnp.ones(2)})


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [*PORT.rglob("*.py"), REPO / "chip_smoke.py",
     REPO / "tools" / "torch_sweep.py"]))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imports(REPO / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "triton"), (path, name)


def test_import_loads_no_jax_and_builds_nothing():
    """Importing every port module pulls in no JAX and no triton, and
    compiles nothing."""
    mods = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (f"import sys\nfor m in {mods!r}:\n    __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]\n"
            "assert not bad, bad\n"
            "import repro_torch.kernels.build as b\n"
            "assert not b._LIBS\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
