"""repro_torch's checkpoint manager against the JAX package's (CPU).

The ports of ``tests/test_train.py``'s four checkpoint tests, then the
layout: a checkpoint written by either framework restores in the other,
bit for bit, for f32 and bf16 TrainStates of qwen2-1.5b-smoke after two
train steps, and re-saving what was restored writes the same files, byte
for byte."""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.sharding import umode as jumode  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.sharding import umode  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402

ARCH = "qwen2-1.5b-smoke"
_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


# ---------------------------------------------------------------------------
# ports of tests/test_train.py's checkpoint tests
# ---------------------------------------------------------------------------

def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "nested": {"b": torch.ones((4,),
                                                  dtype=torch.bfloat16)}},
            "step": 7}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(7, st)
    got, manifest = mgr.restore(device="cpu")
    assert manifest["step"] == 7
    assert torch.equal(got["params"]["w"], st["params"]["w"])
    assert got["params"]["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["nested"]["b"],
                       st["params"]["nested"]["b"])
    assert got["step"] == 7 and isinstance(got["step"], int)


def test_checkpoint_atomicity(tmp_path):
    """A half-written (tmp) checkpoint is never visible."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000099.tmp")
    (tmp_path / "step_00000099.tmp" / "junk.npy").write_bytes(b"xx")
    assert mgr.latest_step() is None
    mgr.save(3, _state())
    assert mgr.latest_step() == 3


def test_checkpoint_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]


def test_async_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, _state())
    mgr.wait()
    assert mgr.latest_step() == 5


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The host snapshot is synchronous: an in-place update right after
    an async save does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    st = _state()
    want = st["params"]["w"].clone()
    mgr.save(1, st)
    st["params"]["w"].add_(100.0)
    mgr.wait()
    got, _ = mgr.restore(device="cpu")
    assert torch.equal(got["params"]["w"], want)


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore()


def test_empty_directory_restores_nothing(tmp_path):
    assert CheckpointManager(str(tmp_path)).restore(device="cpu") == \
        (None, None)


# ---------------------------------------------------------------------------
# the layout across frameworks
# ---------------------------------------------------------------------------

def _batches(cfg, n, first=0):
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2, seed=3))
    return [data.global_batch(first + i) for i in range(n)]


def _bits(x) -> np.ndarray:
    """A leaf's exact bits as numpy: bf16 as uint16, others as stored."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    return arr.view(np.uint16) if str(arr.dtype) == "bfloat16" else arr


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference_state(request):
    """(dtype, the reference's TrainState after two U-mode steps on a 1x1
    mesh)."""
    cfg = jget_config(ARCH).replace(dtype=request.param)
    step, _, _ = jumode.make_train_step(
        cfg, make_mesh((1, 1), ("data", "model")), joptim.OptConfig(**_OPT))
    step = jax.jit(step)
    state = joptim.init_state(japi.init(jax.random.PRNGKey(0), cfg))
    for b in _batches(get_config(ARCH), 2):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return request.param, jax.tree.map(np.asarray, state)


def test_reference_checkpoint_restores_in_port(reference_state, tmp_path):
    dtype, jstate = reference_state
    JManager(str(tmp_path)).save(2, jstate)
    got, manifest = CheckpointManager(str(tmp_path)).restore(device="cpu")
    assert manifest["step"] == 2 and got["step"] == 2
    want = _flatten(jstate)
    flat = _flatten(got)
    assert list(flat) == list(want)
    for path, leaf in want.items():
        if path == "step":
            continue
        t = flat[path]
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
        assert tuple(t.shape) == leaf.shape, path
        np.testing.assert_array_equal(_bits(t), _bits(leaf), err_msg=path)
    assert {str(v.dtype) for k, v in flat.items() if k != "step"} >= \
        {"torch.float32", f"torch.{dtype}"}


def test_port_checkpoint_restores_in_reference(reference_state, tmp_path):
    """The port restores the reference's state, takes two steps of its own
    and saves; the reference restores exactly the port's state."""
    dtype, jstate = reference_state
    JManager(str(tmp_path / "ref")).save(2, jstate)
    state, _ = CheckpointManager(str(tmp_path / "ref")).restore(device="cpu")
    cfg = get_config(ARCH).replace(dtype=dtype)
    step = umode.make_train_step(cfg, optim.OptConfig(**_OPT))
    for b in _batches(cfg, 2, first=2):
        state, _ = step(state, b)
    assert state["step"] == 4
    CheckpointManager(str(tmp_path / "port")).save(4, state)
    got, manifest = JManager(str(tmp_path / "port")).restore()
    assert manifest["step"] == 4
    with open(tmp_path / "ref" / "step_00000002" / "manifest.json") as f:
        ref_manifest = json.load(f)
    assert manifest["leaves"] == ref_manifest["leaves"]
    assert set(manifest) == set(ref_manifest) == {"step", "extra", "leaves"}
    step_file = np.load(tmp_path / "port" / "step_00000004" / "step.npy")
    assert step_file.dtype == np.int32 and step_file.shape == ()
    want = _flatten(state)
    flat = _flatten(got)
    assert list(flat) == list(want)
    for path, leaf in flat.items():
        if path == "step":
            assert int(leaf) == 4 and leaf.dtype == np.int32
            continue
        t = want[path]
        assert str(leaf.dtype) == str(t.dtype).removeprefix("torch."), path
        np.testing.assert_array_equal(_bits(leaf), _bits(t), err_msg=path)


def test_resaved_checkpoint_is_byte_equal(reference_state, tmp_path):
    """The port's save of the state it restored from the reference's
    checkpoint writes the same files, byte for byte, manifest included."""
    _, jstate = reference_state
    JManager(str(tmp_path / "ref")).save(2, jstate)
    state, _ = CheckpointManager(str(tmp_path / "ref")).restore(device="cpu")
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    a, b = tmp_path / "ref" / "step_00000002", \
        tmp_path / "port" / "step_00000002"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors
