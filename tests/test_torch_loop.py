"""repro_torch's fault-tolerant loop, mesh and training example (CPU),
against the JAX package's loop.

The ports of ``tests/test_train.py``'s two loop tests; a replay after an
injected fault bit-identical to the uninterrupted run; the port's losses
against ``repro.train.loop.run`` on the same config, data and 1x1 mesh,
from the same initial state (the reference's, handed to the port as a
step-0 checkpoint), within atol 1e-5, the tolerance
``tests/test_torch_train.py`` holds three train steps to; the port's own
departures: ``KernelBackwardMissing`` is re-raised, never replayed, and
a mesh of more than one device raises."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402

from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro_torch.kernels.ops import KernelBackwardMissing  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.train import loop, optim  # noqa: E402
from repro_torch.train.data import DataConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402

ARCH = "qwen2-1.5b-smoke"


def _mesh():
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def _dc(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)


def _run(tmp_path, steps=14, ckpt_every=5, **kw):
    cfg = get_config(ARCH)
    return run(cfg, _mesh(), _dc(cfg),
               opt_cfg=optim.OptConfig(lr=1e-3, total_steps=steps,
                                       warmup_steps=2),
               loop_cfg=LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                                   ckpt_dir=str(tmp_path), async_ckpt=False,
                                   log_every=100),
               verbose=False, **kw)


# ---------------------------------------------------------------------------
# ports of tests/test_train.py's loop tests
# ---------------------------------------------------------------------------

def test_loop_restart_after_failure(tmp_path):
    rep = _run(tmp_path, fault_schedule={8: RuntimeError("injected node "
                                                         "failure")})
    assert rep.restarts == 1
    assert rep.final_step == 14
    # replayed steps 5..8 after restoring the step-5 checkpoint
    assert rep.steps_run > 14 - 1
    assert np.isfinite(rep.final_loss)


def test_loop_elastic_remesh(tmp_path):
    rep = _run(tmp_path, steps=8, ckpt_every=4,
               remesh_schedule={4: _mesh()})
    assert rep.remesh_events == 1
    assert rep.final_step == 8


# ---------------------------------------------------------------------------
# replay, parity with the reference loop, the port's departures
# ---------------------------------------------------------------------------

def test_fault_replay_is_bit_identical(tmp_path):
    """Steps 5..13 replayed after the step-5 restore give the
    uninterrupted run's losses bit for bit (f32, CPU)."""
    clean = _run(tmp_path / "clean")
    faulted = _run(tmp_path / "faulted",
                   fault_schedule={8: RuntimeError("injected")})
    assert len(clean.losses) == 14 and len(faulted.losses) == 14 + 3
    assert faulted.losses[:8] == clean.losses[:8]
    assert faulted.losses[8:] == clean.losses[5:]
    assert faulted.final_loss == clean.final_loss


def test_loop_losses_match_reference(tmp_path):
    """The reference's loop and the port's, each with the fault at step 8,
    from the reference's initial state: every loss within atol 1e-5."""
    jcfg = jget_config(ARCH)
    kw = dict(total_steps=14, ckpt_every=5, async_ckpt=False,
              log_every=100)
    jopt = dict(lr=1e-3, total_steps=14, warmup_steps=2)
    want = jloop.run(jcfg, jmake_mesh((1, 1), ("data", "model")),
                     JDataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                 global_batch=2),
                     opt_cfg=joptim.OptConfig(**jopt),
                     loop_cfg=jloop.LoopConfig(ckpt_dir=str(tmp_path / "j"),
                                               **kw),
                     fault_schedule={8: RuntimeError("injected")},
                     verbose=False)
    # the reference's build() inits from PRNGKey(0): that state, as a
    # step-0 checkpoint, is where the port's loop starts
    init = joptim.init_state(japi.init(jax.random.PRNGKey(0), jcfg))
    JManager(str(tmp_path / "t")).save(0, jax.tree.map(np.asarray, init))
    cfg = get_config(ARCH)
    got = run(cfg, _mesh(), _dc(cfg), opt_cfg=optim.OptConfig(**jopt),
              loop_cfg=LoopConfig(ckpt_dir=str(tmp_path / "t"), **kw),
              fault_schedule={8: RuntimeError("injected")}, verbose=False)
    assert (got.restarts, got.final_step, got.steps_run) == \
        (want.restarts, want.final_step, want.steps_run) == (1, 14, 17)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-5, rtol=0)


def test_kernel_backward_missing_is_not_replayed(tmp_path, monkeypatch,
                                                 capsys):
    """A fault of the program raises at once: one call of the step, no
    restore (restarts == 0), nothing replayed."""
    calls = []

    def make_step(cfg, opt_cfg=None):
        def step(state, batch):
            calls.append(state["step"])
            raise KernelBackwardMissing("ssd_chunk_kernel: no backward")
        return step
    monkeypatch.setattr(loop.umode, "make_train_step", make_step)
    cfg = get_config(ARCH)
    with pytest.raises(KernelBackwardMissing):
        run(cfg, _mesh(), _dc(cfg),
            loop_cfg=LoopConfig(total_steps=4, ckpt_dir=str(tmp_path),
                                async_ckpt=False))
    assert calls == [0]
    assert "FAILED" not in capsys.readouterr().out


def test_other_errors_still_restore(tmp_path, monkeypatch):
    """Any other error of a step takes the reference's restore path:
    with no checkpoint yet, the loop re-inits at step 0 and goes on."""
    real = loop.umode.make_train_step
    failed = []

    def make_step(cfg, opt_cfg=None):
        step = real(cfg, opt_cfg)

        def flaky(state, batch):
            if state["step"] == 2 and not failed:
                failed.append(True)
                raise RuntimeError("device lost")
            return step(state, batch)
        return flaky
    monkeypatch.setattr(loop.umode, "make_train_step", make_step)
    rep = _run(tmp_path, steps=4, ckpt_every=10)
    assert rep.restarts == 1 and rep.final_step == 4
    assert rep.steps_run == 2 + 4


def test_straggler_counted(tmp_path):
    rep = _run(tmp_path, steps=3, ckpt_every=10)
    assert rep.straggler_steps == 0
    cfg = get_config(ARCH)
    rep = run(cfg, _mesh(), _dc(cfg),
              loop_cfg=LoopConfig(total_steps=3, ckpt_every=10,
                                  ckpt_dir=str(tmp_path / "s"),
                                  async_ckpt=False, step_deadline_s=0.0),
              verbose=False)
    assert rep.straggler_steps == 3 and len(rep.step_s) == 3


def test_loop_resumes_from_the_latest_checkpoint(tmp_path):
    first = _run(tmp_path, steps=6, ckpt_every=3)
    again = _run(tmp_path, steps=8, ckpt_every=3)
    assert first.final_step == 6 and again.final_step == 8
    assert again.steps_run == 2


@pytest.mark.parametrize("shape", [(2, 1), (1, 4), (2, 2)])
def test_make_mesh_of_more_than_one_device_raises(shape):
    with pytest.raises(NotImplementedError, match="item 6"):
        make_mesh(shape, ("data", "model"), device="cpu")


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"))


def test_make_mesh_shape():
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1


def test_train_lm_example_on_cpu(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep = mod.main(["--steps", "24", "--batch", "2", "--seq", "32",
                    "--device", "cpu"])
    assert rep.final_step == 24 and rep.restarts == 0
    assert "uniform baseline" in capsys.readouterr().out
