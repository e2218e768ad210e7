"""repro_torch's training substrate against the JAX package (CPU):
the optimizer, the synthetic data, ``make_train_step`` and the launcher.

Tolerances: ``lr_at`` rtol 1e-6 (both f32 arithmetic; cos may differ in
its last bit); AdamW moments rtol 1e-5 and f32 params 1e-6 (the same f32
ops, fused differently); bf16 params within one bf16 ulp (2^-7 relative:
f32 values that differ in their last bits can round to neighbouring bf16
values); SyntheticLM bit-equal.  Train steps on qwen2-1.5b-smoke: losses
atol 1e-5, moments atol 1e-7 + rtol 1e-4 (f32 gradients summed in
another order), params atol lr / 10: Adam divides each gradient by its
own root-mean-square, so an element whose gradient is at the f32 noise
floor of the two frameworks moves by up to lr in either direction."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.sharding import umode as jumode  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.sharding import umode  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM, make_batch  # noqa: E402

from _torch_parity import shared_params  # noqa: E402

ARCH = "qwen2-1.5b-smoke"


# ---------------------------------------------------------------------------
# ports of tests/test_train.py's optimizer tests
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    state = optim.init_state({"w": torch.tensor([5.0, -3.0, 2.0])})
    cfg = optim.OptConfig(lr=0.2, weight_decay=0.0, warmup_steps=1,
                          total_steps=200, schedule="constant")
    for _ in range(150):
        g = {"w": 2 * state["params"]["w"]}        # grad of sum(w^2)
        state, _ = optim.adamw_update(state, g, cfg)
    assert float(state["params"]["w"].abs().max()) < 0.05


def test_grad_clip_bounds_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert float(optim.global_norm(clipped)) <= 1.0 + 1e-5


def test_lr_schedule_warmup_and_decay():
    cfg = optim.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          schedule="cosine")
    lrs = [optim.lr_at(cfg, s) for s in [0, 5, 10, 50, 99]]
    assert lrs[0] < lrs[1] < lrs[2]            # warmup rises
    assert lrs[2] > lrs[3] > lrs[4]            # cosine decays
    assert lrs[4] < 0.01


def test_moments_are_f32_under_bf16_params():
    st = optim.init_state({"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert st["mu"]["w"].dtype == torch.float32
    assert st["nu"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# ports of tests/test_train.py's data tests
# ---------------------------------------------------------------------------

def test_data_deterministic():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=8, seed=1)
    a = SyntheticLM(cfg).global_batch(3)
    b = SyntheticLM(cfg).global_batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_data_shard_consistency():
    """Sharded generation == slicing the global batch (elastic restart)."""
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=2)
    data = SyntheticLM(cfg)
    full = data.global_batch(5)
    for shard, n in [(0, 4), (3, 4), (1, 2)]:
        piece = data.host_shard(5, shard, n)
        per = 8 // n
        np.testing.assert_array_equal(
            piece["tokens"], full["tokens"][shard * per:(shard + 1) * per])


def test_data_targets_shifted():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=2, seed=0)
    b = SyntheticLM(cfg).global_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


# ---------------------------------------------------------------------------
# parity with the JAX package on the same numpy inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    got = [optim.lr_at(optim.OptConfig(**cfg), s) for s in range(45)]
    want = [float(joptim.lr_at(joptim.OptConfig(**cfg), jnp.asarray(s)))
            for s in range(45)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(rng, dtype):
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "stack": {"ln": 1 + rng.standard_normal((2, 5)).astype(np.float32),
                      "m": rng.standard_normal((2, 3, 5)).astype(np.float32)},
            "b": rng.standard_normal((6,)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three AdamW steps on the same params and gradients (with a clipping
    step and weight decay on the ndim >= 2 leaves, the stacked (2, 5)
    'norm' included): params, moments, grad norms and lrs."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng, dtype)
    grads = [jax.tree.map(lambda x, s=s: (s * x).astype(np.float32),
                          _tree(rng, dtype)) for s in (0.05, 3.0, 0.2)]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
               grad_clip=1.0)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jstate = joptim.init_state(jax.tree.map(lambda x: jnp.asarray(x, jdt), p0))
    tstate = optim.init_state(optim.tree_map(
        lambda x: torch.from_numpy(x).to(tdt), p0))
    for g in grads:
        jstate, jm = joptim.adamw_update(
            jstate, jax.tree.map(lambda x: jnp.asarray(x, jdt), g),
            joptim.OptConfig(**cfg))
        tstate, tm = optim.adamw_update(
            tstate, optim.tree_map(lambda x: torch.from_numpy(x).to(tdt), g),
            optim.OptConfig(**cfg))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tstate["step"] == int(jstate["step"]) == 3
    for key, tol in (("mu", dict(rtol=1e-5, atol=1e-7)),
                     ("nu", dict(rtol=1e-5, atol=1e-9)),
                     ("params", dict(rtol=1e-6, atol=1e-7) if dtype ==
                      "float32" else dict(rtol=2 ** -7, atol=0))):
        want = jax.tree.leaves(jstate[key])
        got = optim.leaves(tstate[key])
        assert len(got) == len(want)
        for t, j in zip(got, want):
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11)])
def test_synthetic_lm_is_bit_equal_to_reference(seed, step):
    dc = dict(vocab_size=151936, seq_len=40, global_batch=3, seed=seed)
    got = SyntheticLM(DataConfig(**dc)).global_batch(step)
    want = jdata.SyntheticLM(jdata.DataConfig(**dc)).global_batch(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    cfg = get_config(ARCH)
    cell = type("Cell", (), {"seq_len": 12, "global_batch": 2})()
    np.testing.assert_array_equal(
        make_batch(cfg, cell, step, seed)["tokens"],
        jdata.make_batch(jget_config(ARCH), cell, step, seed)["tokens"])


@pytest.fixture(scope="module")
def reference_steps():
    """Three steps of the reference's U-mode train step on a 1x1 CPU mesh
    from shared_params; returns (params, batches, losses, final state)."""
    jp, tp = shared_params(ARCH)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        t = rng.integers(0, get_config(ARCH).vocab_size, (2, 21)) \
            .astype(np.int32)
        batches.append({"tokens": t[:, :-1], "targets": t[:, 1:]})
    step, _, _ = jumode.make_train_step(
        jget_config(ARCH), make_mesh((1, 1), ("data", "model")),
        joptim.OptConfig(**_OPT))
    step = jax.jit(step)
    state = joptim.init_state(jp)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return tp, batches, losses, state


_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("attn_impl", ["ref", "flash"])
def test_train_step_matches_reference(reference_steps, attn_impl):
    """Three make_train_step steps on qwen2-1.5b-smoke (f32; the port's
    'flash' runs the kernel wrapper's plain version on the CPU) against
    three steps of repro.sharding.umode.make_train_step."""
    tp, batches, want_losses, jstate = reference_steps
    cfg = get_config(ARCH).replace(attn_impl=attn_impl)
    state = optim.init_state(copy.deepcopy(tp))
    step = umode.make_train_step(cfg, optim.OptConfig(**_OPT))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "grad_norm", "lr"}
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


def test_launch_train_on_cpu_lowers_the_loss(capsys, tmp_path):
    assert launch_train.main(["--device", "cpu", "--steps", "24",
                              "--batch", "4", "--seq", "32",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[loop] step ")]
    assert len(losses) == 24 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    assert "final loss" in out and "tok/s" in out


def test_launch_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])
