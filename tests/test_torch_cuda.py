"""repro_torch's CUDA kernels vs their plain versions, on the card.

Every test here is marked ``cuda`` and skips, from inside the test, where
torch sees no GPU.  On a machine with one (and without JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 2e-5 / rtol 1e-4 for attention and 1e-5 for
rmsnorm (sums in another order, no TF32); bf16 3e-2 (one bf16 rounding
of the output at another place)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, dtype, device):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,causal", [
    (1, 1, 12, 2, 128, True), (2, 77, 12, 2, 128, True),
    (1, 200, 8, 2, 64, True), (2, 128, 4, 2, 16, True),
    (1, 300, 6, 2, 32, True), (2, 96, 4, 4, 64, False)])
def test_flash_kernel_matches_plain(cuda, dtype, B, S, H, K, hd, causal):
    dt = getattr(torch, dtype)
    q = _rand((B, S, H, hd), 1, dt, cuda)
    k, v = _rand((B, S, K, hd), 2, dt, cuda), _rand((B, S, K, hd), 3, dt, cuda)
    n = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    assert got.dtype == dt and got.shape == q.shape
    _assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal),
                  F32 if dtype == "float32" else BF16)


@pytest.mark.cuda
def test_flash_kernel_takes_strided_heads(cuda):
    """q/k/v as views of one fused projection, as qkv() could hand them."""
    B, S, H, K, hd = 1, 50, 4, 2, 64
    fused = _rand((B, S, (H + 2 * K) * hd), 4, torch.float32, cuda)
    q, k, v = fused.split([H * hd, K * hd, K * hd], dim=-1)
    q, k, v = (q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd))
    _assert_close(ops.flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v), F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 1536), (4, 1536), (995, 1536),
                                    (3, 100)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    dt = getattr(torch, dtype)
    x, w = _rand((rows, d), 5, dt, cuda), _rand((d,), 6, dt, cuda)
    n = ops.rmsnorm.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == n + 1
    _assert_close(got, ref.rmsnorm_ref(x, w),
                  dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else BF16)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = _rand((4, 64), 7, torch.float16, cuda)
    with pytest.raises(TypeError):
        ops.rmsnorm(x, x[0])
    q = _rand((1, 8, 4, 48), 8, torch.float32, cuda)        # hd 48
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention(q, q[:, :, :2], q[:, :, :2])
