"""repro_torch kernels: the plain versions vs the JAX package's Pallas
kernels (interpret mode on the CPU) and oracles, and the wrappers'
routing.  The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.

Tolerances are tests/test_kernels.py's: f32 atol 2e-5 / rtol 1e-4 (sums
in another order), bf16 3e-2 (bf16 rounds at other places)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_kernel  # noqa: E402

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(B, Sq, Skv, H, K, hd, seed=0):
    return (_rand((B, Sq, H, hd), seed), _rand((B, Skv, K, hd), seed + 1),
            _rand((B, Skv, K, hd), seed + 2))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 128, 4, 2, 16),        # smoke heads
    (2, 256, 8, 2, 64),        # GQA 4:1, two q tiles
    (1, 128, 12, 2, 128),      # qwen2-1.5b heads
])
def test_flash_ref_matches_jax_kernel(B, S, H, K, hd):
    q, k, v = _qkv(B, S, S, H, K, hd)
    want = jops.flash_attention(*_j(q, k, v), causal=True)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_flash_ref_matches_jax_kernel_bf16():
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=3)
    want = jops.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal=True)
    got = ref.flash_attention_ref(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("Sq,Skv,causal", [
    (77, 77, True),            # ragged: the JAX kernel cannot take it
    (200, 200, True),
    (1, 1, True),
    (5, 77, True),             # bottom-right alignment, as the oracle's
    (64, 96, False),
])
def test_flash_ref_matches_jax_ref(Sq, Skv, causal):
    q, k, v = _qkv(2, Sq, Skv, 6, 2, 32, seed=5)
    want = jref.flash_attention_ref(*_j(q, k, v), causal=causal)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_flash_wrapper_runs_plain_version_on_cpu():
    q, k, v = _t(*_qkv(1, 77, 77, 4, 2, 16, seed=7))
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=True))
    assert ops.launch_counts() == before       # no kernel was launched


def test_flash_wrapper_rejects_misaligned_causal_call():
    q, k, v = _t(*_qkv(1, 5, 77, 4, 2, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        ops.flash_attention(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(64, 256), (100, 512), (1, 128),
                                    (4, 1536)])
def test_rmsnorm_ref_matches_jax(rows, d):
    x, w = _rand((rows, d), 11), _rand((d,), 12)
    got = _np(ref.rmsnorm_ref(*_t(x, w)))
    np.testing.assert_allclose(got, _np(jops.rmsnorm(*_j(x, w))), **F32)
    np.testing.assert_allclose(got, _np(jlayers.rms_norm(*_j(x, w))), **F32)
    np.testing.assert_allclose(got, _np(jref.rmsnorm_ref(*_j(x, w))), **F32)


def test_rmsnorm_ref_matches_jax_bf16():
    x, w = _rand((3, 5, 1536), 13), 1 + 0.1 * _rand((1536,), 14)
    got = ref.rmsnorm_ref(*_t(x, w, dtype=torch.bfloat16), eps=1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 5, 1536)
    want = jlayers.rms_norm(*_j(x, w, dtype=jnp.bfloat16), eps=1e-6)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_rmsnorm_wrapper_runs_plain_version_on_cpu():
    x, w = _t(_rand((4, 1536), 15), _rand((1536,), 16))
    before = ops.launch_counts()
    assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# the fused norms: the models' prologue (residual add, Mamba2's gate) and
# the norm, against the JAX models' ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("rows,d", [(4, 1536), (7, 2048), (1, 128)])
def test_add_rmsnorm_ref_matches_jax_residual_and_norm(dtype, tol, rows, d):
    """JAX: h = h + a; rms_norm(h) (repro/models/transformer.py)."""
    x, r = _rand((rows, d), 50), _rand((rows, d), 51)
    w = 1 + 0.1 * _rand((d,), 52)
    jh = _j(x, dtype=getattr(jnp, dtype))[0] + _j(r, dtype=getattr(jnp, dtype))[0]
    want = jlayers.rms_norm(jh, _j(w, dtype=getattr(jnp, dtype))[0])
    h, out = ref.add_rmsnorm_ref(*_t(x, r, w, dtype=getattr(torch, dtype)))
    assert h.dtype == out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(h), _np(jh))
    np.testing.assert_allclose(_np(out), _np(want), **tol)


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("rows,d", [(4, 4096), (3, 256)])
def test_gated_rmsnorm_ref_matches_jax_gated_norm(dtype, tol, rows, d):
    """JAX: rms_norm(y * silu(z), norm_w) (repro/models/ssm.py)."""
    import jax
    y, z = _rand((rows, d), 53), 2 * _rand((rows, d), 54)
    w = 1 + 0.1 * _rand((d,), 55)
    jy, jz, jw = _j(y, z, w, dtype=getattr(jnp, dtype))
    want = jlayers.rms_norm(jy * jax.nn.silu(jz), jw)
    got = ref.gated_rmsnorm_ref(*_t(y, z, w, dtype=getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_fused_norm_wrappers_run_plain_versions_on_cpu():
    x, r, w = _t(_rand((4, 1536), 56), _rand((4, 1536), 57),
                 _rand((1536,), 58))
    before = ops.launch_counts()
    h, out = ops.add_rmsnorm(x, r, w)
    assert torch.equal(h, x + r) and torch.equal(out, ref.rmsnorm_ref(x + r, w))
    assert torch.equal(ops.gated_rmsnorm(x, r, w),
                       ref.gated_rmsnorm_ref(x, r, w))
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# grad: a kernel without a backward refuses it on the card
# ---------------------------------------------------------------------------

def test_check_no_grad_raises_for_an_input_that_requires_grad():
    w = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="rmsnorm: the CUDA kernel has no "
                                           "backward.*No model trains "
                                           "through it"):
        ops.check_no_grad("rmsnorm", torch.ones(2, 8), w)


def test_check_no_grad_passes_without_grad():
    w = torch.ones(8, requires_grad=True)
    with torch.no_grad():
        ops.check_no_grad("rmsnorm", torch.ones(2, 8), w)
    ops.check_no_grad("rmsnorm", torch.ones(2, 8), torch.ones(8))
    with torch.inference_mode():
        ops.check_no_grad("flash_attention", w)


def test_cpu_wrappers_still_differentiate():
    """On the CPU the wrappers run the plain versions, which autograd
    differentiates as usual: no refusal there."""
    x, r = _t(_rand((3, 64), 59), _rand((3, 64), 60))
    w = torch.ones(64, requires_grad=True)
    h, out = ops.add_rmsnorm(x, r, w)
    (out.sum() + ops.gated_rmsnorm(x, r, w).sum()
     + ops.rmsnorm(x, w).sum()).backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()


# ---------------------------------------------------------------------------
# launchers and build: what runs without a card
# ---------------------------------------------------------------------------

def test_launchers_refuse_cpu_tensors():
    """The CUDA launchers raise before building or launching anything."""
    x, w = _t(_rand((4, 64), 17), _rand((64,), 18))
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.rmsnorm(x, w)
    q, k, v = _t(*_qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.add_rmsnorm(x, x, w)
    with pytest.raises(ValueError, match="CUDA"):
        rms_kernel.gated_rmsnorm(x, x, w)


def test_build_names_libraries_by_source_hash():
    assert build.sources() == ["bitonic", "flash_attention",
                               "flash_attention_bwd", "rmsnorm", "ssd",
                               "ssd_bwd", "stencil"]
    path = build.lib_path("rmsnorm")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("librmsnorm_") and path.suffix == ".so"
    assert build.lib_path("rmsnorm") == path          # stable
    assert build.lib_path("flash_attention") != path
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
