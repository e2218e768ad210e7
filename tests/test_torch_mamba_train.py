"""Training mamba2-1.3b-smoke in repro_torch against the JAX package
(CPU): the loss and every gradient against ``jax.value_and_grad`` of the
reference loss, three AdamW steps against the reference's U-mode step on
a 1x1 mesh, checkpoints across the two frameworks, the loop's replay,
the launcher, and the traced train step.

With ``use_kernels`` the port runs ``ops.ssd_chunked`` and the fused
norms, whose plain versions run on the CPU; the reference runs its plain
``ssd_scan`` whatever ``use_pallas`` says.  Tolerances are those of the
qwen tests: loss atol 1e-5 and each gradient leaf within 1e-4 of its max
|g| (``test_torch_grad.py``); train steps' losses atol 1e-5, moments atol
1e-7 + rtol 1e-4 and params atol lr / 10 (``test_torch_train.py``);
checkpoints bit for bit (``test_torch_checkpoint.py``)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.sharding import umode as jumode  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.core import hlo  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402
from repro_torch.sharding import umode  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager, _flatten  # noqa: E402
from repro_torch.train.data import DataConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, run  # noqa: E402

from _torch_parity import (assert_leaves_close, loss_and_grads,  # noqa: E402
                           shared_params)

ARCH = "mamba2-1.3b-smoke"
LEAF_TOL = 1e-4
_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


def _batch(seed, B=2, S=16, mask=False):
    toks = np.random.default_rng(seed).integers(
        0, get_config(ARCH).vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["mask"] = (np.arange(S) < S - 4).astype(np.float32)[None] \
            .repeat(B, 0)
    return batch


# ---------------------------------------------------------------------------
# the loss and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("S,mask", [(16, False), (19, False), (19, True)])
def test_loss_grads_match_jax(params, use_kernels, S, mask):
    """S = 16 is two whole chunks of Q = 8; S = 19 pads the last one."""
    jp, tp = params
    batch = _batch(21, S=S, mask=mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: japi.loss(p, jget_config(ARCH), jb))(jp)
    loss, got = loss_and_grads(
        tp, get_config(ARCH).replace(use_kernels=use_kernels),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) < 1e-5
    assert_leaves_close(got, want, LEAF_TOL)


# ---------------------------------------------------------------------------
# AdamW steps against the reference's U-mode step
# ---------------------------------------------------------------------------

def _jstep(cfg):
    step, _, _ = jumode.make_train_step(
        cfg, jmake_mesh((1, 1), ("data", "model")), joptim.OptConfig(**_OPT))
    return jax.jit(step)


@pytest.fixture(scope="module")
def reference_steps(params):
    """Three steps of the reference's U-mode train step on a 1x1 CPU mesh
    from shared_params: (batches, losses, final state)."""
    jp, _ = params
    batches = [_batch(30 + i, S=19) for i in range(3)]
    step = _jstep(jget_config(ARCH))
    state = joptim.init_state(jp)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return batches, losses, state


@pytest.mark.parametrize("use_kernels", [False, True])
def test_train_step_matches_reference(params, reference_steps, use_kernels):
    _, tp = params
    batches, want_losses, jstate = reference_steps
    cfg = get_config(ARCH).replace(use_kernels=use_kernels)
    state = optim.init_state(copy.deepcopy(tp))
    step = umode.make_train_step(cfg, optim.OptConfig(**_OPT))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=0)
    assert not any(t.requires_grad for t in optim.leaves(state["params"]))
    for key, tol in (("mu", dict(atol=1e-7, rtol=1e-4)),
                     ("params", dict(atol=_OPT["lr"] / 10, rtol=0))):
        flat = jax.tree_util.tree_flatten_with_path(jstate[key])[0]
        assert len(flat) == len(optim.leaves(state[key]))
        for path, leaf in flat:
            t = state[key]
            for k in path:
                t = t[k.key]
            np.testing.assert_allclose(t.numpy(), np.asarray(leaf), **tol,
                                       err_msg=f"{key} {path}")


# ---------------------------------------------------------------------------
# checkpoints across the two frameworks
# ---------------------------------------------------------------------------

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
    """(dtype, the reference's TrainState after one U-mode step on a 1x1
    mesh): bf16 weights beside the f32 SSM leaves."""
    cfg = jget_config(ARCH).replace(dtype=request.param)
    state = joptim.init_state(japi.init(jax.random.PRNGKey(0), cfg))
    state, _ = _jstep(cfg)(state, {k: jnp.asarray(v) for k, v in
                                   _batch(40).items()})
    return request.param, jax.tree.map(np.asarray, state)


def test_reference_checkpoint_round_trips_through_the_port(reference_state,
                                                           tmp_path):
    """The reference's checkpoint restores in the port bit for bit; the
    port's save of it is the same files, byte for byte; the port takes a
    step and saves, and the reference restores exactly that state."""
    import filecmp
    import os
    dtype, jstate = reference_state
    JManager(str(tmp_path / "ref")).save(1, jstate)
    state, manifest = CheckpointManager(str(tmp_path / "ref")).restore(
        device="cpu")
    assert manifest["step"] == 1 and state["step"] == 1
    want, got = _flatten(jstate), _flatten(state)
    assert list(got) == list(want)
    for path, leaf in want.items():
        if path != "step":
            assert str(got[path].dtype).removeprefix("torch.") == \
                str(leaf.dtype), path
            np.testing.assert_array_equal(_bits(got[path]), _bits(leaf),
                                          err_msg=path)
    CheckpointManager(str(tmp_path / "resaved")).save(1, state)
    a, b = tmp_path / "ref" / "step_00000001", \
        tmp_path / "resaved" / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors

    step = umode.make_train_step(get_config(ARCH).replace(dtype=dtype),
                                 optim.OptConfig(**_OPT))
    state, _ = step(state, _batch(41))
    CheckpointManager(str(tmp_path / "port")).save(2, state)
    back, manifest = JManager(str(tmp_path / "port")).restore()
    assert manifest["step"] == 2
    want, got = _flatten(state), _flatten(back)
    assert list(got) == list(want)
    for path, leaf in got.items():
        if path == "step":
            assert int(leaf) == 2 and leaf.dtype == np.int32
            continue
        np.testing.assert_array_equal(_bits(leaf), _bits(want[path]),
                                      err_msg=path)


# ---------------------------------------------------------------------------
# the loop, the launcher and the tracer
# ---------------------------------------------------------------------------

def test_loop_replays_a_fault_bit_identically(tmp_path):
    """The kernel path (plain versions on the CPU) through the loop, a
    checkpoint every 2 steps and a failure at step 3: the replayed step-2
    loss equals its first run."""
    cfg = get_config(ARCH)
    rep = run(cfg, make_mesh((1, 1), ("data", "model"), device="cpu"),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=24,
                         global_batch=2),
              loop_cfg=LoopConfig(total_steps=5, ckpt_every=2,
                                  ckpt_dir=str(tmp_path), async_ckpt=False),
              fault_schedule={3: RuntimeError("injected")}, verbose=False)
    assert (rep.restarts, rep.final_step, rep.steps_run) == (1, 5, 6)
    assert rep.losses[3] == rep.losses[2]
    assert np.isfinite(rep.losses).all()


def test_launch_train_mamba_on_cpu_lowers_the_loss(capsys, tmp_path):
    assert launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                              "16", "--batch", "4", "--seq", "32",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[loop] step ")]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_train_step_traces_one_op_per_kernel_call():
    """One make_train_step step of the kernel path on meta: one trace op
    per kernel call, each backward once a layer, with cost.py's counts."""
    cfg = get_config(ARCH)
    L, B, S = cfg.num_layers, 2, 20
    state = optim.init_state(api.init(0, cfg, device="meta"))
    batch = {k: torch.zeros((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    cost = hlo.analyze(umode.make_train_step(cfg, optim.OptConfig()),
                       state, batch)
    assert hlo.kernel_ops(cost.trace) == {
        "ssd_chunk_kernel": L, "ssd_chunk_bwd": L, "gated_rmsnorm": L,
        "gated_rmsnorm_bwd": L, "rmsnorm": 1, "rmsnorm_bwd": 1,
        "add_rmsnorm": L, "add_rmsnorm_bwd": L}
    # S = 20 pads to 3 chunks of Q = 8: R = B * 3
    Q, H, P, N = cfg.ssm_chunk, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    x = torch.empty((B * 3, H, Q, P), device="meta")
    Bm = torch.empty((B * 3, H, Q, N), device="meta")
    g = torch.empty((B, S, cfg.d_inner), dtype=cfg.torch_dtype,
                    device="meta")
    w = torch.empty((cfg.d_inner,), dtype=cfg.torch_dtype, device="meta")
    want = {"ssd_chunk_bwd": kcost.ssd_chunk_bwd(x, Bm),
            "gated_rmsnorm_bwd": kcost.gated_rmsnorm_bwd(g, w)}
    for op in cost.trace:
        if op.name in want:
            assert (op.flops, op.hbm_bytes) == want[op.name]
