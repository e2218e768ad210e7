"""repro_torch stencil2d: the plain version vs the JAX package's Pallas
kernel (interpret mode on the CPU) and its oracle, the wrapper's routing,
and the SC D-mode identity the port builds on.  The CUDA kernel itself
is tested on the card by tests/test_torch_cuda.py.

Tolerance: f32 atol 1e-5 (the same products summed in the same (dy, dx)
order; XLA may contract them into FMAs); bf16 one bf16 ulp at the
outputs' magnitude (3e-2, tests/test_kernels.py's)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.patterns import sc as jsc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import stencil as stencil_kernel  # noqa: E402

F32 = dict(atol=1e-5, rtol=0)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("H,W,K", [(128, 64, 3), (256, 128, 5), (64, 64, 3)])
def test_plain_matches_jax_kernel(H, W, K):
    """tests/test_kernels.py::test_stencil's shapes and block rows."""
    img, kern = _rand((H, W), 29), _rand((K, K), 30)
    want = np.asarray(jops.stencil2d(jnp.asarray(img), jnp.asarray(kern),
                                     block_rows=min(64, H)))
    got = ref.stencil2d_ref(_t(img), _t(kern))
    assert got.dtype == torch.float32 and got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("H,W,K", [(100, 70, 3), (37, 53, 5), (1, 1, 3),
                                   (2, 9, 5)])
def test_plain_matches_jax_ref_at_ragged_shapes(H, W, K):
    """Shapes the TPU kernel's block rows do not divide, against its
    oracle."""
    img, kern = _rand((H, W), 31), _rand((K, K), 32)
    want = np.asarray(jref.stencil2d_ref(jnp.asarray(img), jnp.asarray(kern)))
    np.testing.assert_allclose(
        ref.stencil2d_ref(_t(img), _t(kern)).numpy(), want, **F32)


def test_plain_bf16_matches_jax_ref():
    img, kern = _rand((64, 48), 33), _rand((3, 3), 34)
    want = np.asarray(jref.stencil2d_ref(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(kern, jnp.bfloat16)),
        np.float32)
    got = ref.stencil2d_ref(_t(img).bfloat16(), _t(kern).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


def test_wrapper_runs_the_plain_version_on_cpu():
    img, kern = _t(_rand((40, 30), 35)), _t(_rand((5, 5), 36))
    n = ops.stencil2d.launches
    got = ops.stencil2d(img, kern)
    assert ops.stencil2d.launches == n          # no kernel on the CPU
    torch.testing.assert_close(got, ref.stencil2d_ref(img, kern), rtol=0,
                               atol=0)


def test_wrapper_refuses_mixed_devices():
    meta = torch.empty((3, 3), device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        ops.stencil2d(_t(_rand((8, 8), 37)), meta)


def test_launcher_refuses_cpu_tensors():
    """The CUDA launcher never runs a CPU tensor (nor builds anything)."""
    with pytest.raises(ValueError, match="CUDA"):
        stencil_kernel.stencil2d(_t(_rand((8, 8), 38)), _t(_rand((3, 3), 39)))


@pytest.mark.parametrize("h,W", [(32, 128), (1, 16), (5, 7)])
def test_extended_rows_equal_stencil_padded(h, W):
    """Rows 1..h of a same-padded 3x3 stencil over a shard's (h+2, W)
    extended rows are the reference's ``_stencil_padded`` of them: the
    identity SC's D-mode routes through the kernel."""
    ext, kern = _rand((h + 2, W), 40), _rand((3, 3), 41)
    want = np.asarray(jsc._stencil_padded(jnp.asarray(ext),
                                          jnp.asarray(kern)))
    got = ops.stencil2d(_t(ext), _t(kern))[1:-1]
    np.testing.assert_allclose(got.numpy(), want, **F32)
