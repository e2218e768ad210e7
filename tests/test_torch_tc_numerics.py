"""The numerical design of the tensor-core kernels, in plain torch on the
CPU, against the JAX package's oracles (``repro.kernels.ref``).

The card's kernels cannot run here, so these tests emulate their
arithmetic and show that it holds the gates the kernels are held to on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 2):

* flash attention, bf16: the probabilities P rounded to bf16 before
  P V (the A operand of the second wgmma), with Q K^T and P V summed in
  f32 over 64-key tiles and an online softmax, holds the bf16 tolerance
  3e-2 at qwen2-1.5b's heads;
* the SSD chunk with every product in 3xTF32 (a = hi + lo, both TF32;
  a b = lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in f32) holds the SSD
  kernel's 1e-4 at mamba2-1.3b's head width, while a single TF32 product
  misses it: that is why the kernel splits.

TF32 is emulated by zeroing the 13 low mantissa bits of an f32 through
an int32 view (the tensor cores read an f32 register that way); the
kernel rounds to nearest instead (cvt.rna), which is no less exact.
Inputs come from a numpy seed and go to both frameworks."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402

BF16 = dict(atol=3e-2, rtol=3e-2)
SSD_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_kernels.py's
KV_TILE = 64                              # keys per tile of the kernel


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# emulation helpers
# ---------------------------------------------------------------------------

def tf32(a: torch.Tensor) -> torch.Tensor:
    """a (f32) with the 13 low mantissa bits zeroed: a TF32 value."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split_tf32(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from three TF32 products summed in f32 (small terms first)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def ssd_chunk_emulated(mm, x, dt, cs, Bm, Cm):
    """ssd_chunk_ref's function with its three products taken by ``mm``
    and everything else (decay, mask, dt, w) in f32, as in the kernel."""
    Q = x.shape[2]
    scores = mm(Cm, Bm.transpose(-1, -2))                  # (R,H,Q,Q)
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.where(mask, torch.exp(cs[..., :, None] - cs[..., None, :]),
                        0.0)
    att = scores * decay * dt[..., None, :]
    y = mm(att, x)
    w = torch.exp(cs[..., -1:] - cs) * dt
    s = mm((Bm * w[..., None]).transpose(-1, -2), x)       # (R,H,N,P)
    return y, s


def flash_bf16_p(q, k, v, causal=True):
    """The bf16 kernel's arithmetic: q, k, v bf16 -> (B,Sq,H,hd) bf16.
    S = Q K^T in f32 per 64-key tile, online softmax with (m, l) in f32,
    P rounded to bf16 before P V, O and l summed in f32."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B,K,1,Skv,hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((B, K, G, Sq, 1), -math.inf)
    l = torch.zeros((B, K, G, Sq, 1))
    acc = torch.zeros((B, K, G, Sq, hd))
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, KV_TILE):
        kt, vt = kf[..., k0:k0 + KV_TILE, :], vf[..., k0:k0 + KV_TILE, :]
        s = qg @ kt.transpose(-1, -2)
        cols = k0 + torch.arange(kt.shape[-2])[None, :]
        if causal:
            s = s.masked_fill(cols > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp((m - m_use) * scale)
        p = torch.exp((s - m_use) * scale)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt
        m = m_new
    out = acc / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).bfloat16()


def _ssd_inputs(R, H, Q, P, N, seed):
    """x, dt, cs, Bm, Cm as tests/test_kernels.py draws them."""
    x = _rand((R, H, Q, P), seed)
    dt = np.logaddexp(_rand((R, H, Q), seed + 1), 0.0).astype(np.float32)
    A = -np.exp(_rand((H,), seed + 2))
    cs = np.cumsum(dt * A[None, :, None], axis=-1).astype(np.float32)
    return (x, dt, cs, _rand((R, H, Q, N), seed + 3),
            _rand((R, H, Q, N), seed + 4))


def _violations(got, want, tol):
    """Elements outside atol + rtol * |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return int((np.abs(got - want) > tol["atol"]
                + tol["rtol"] * np.abs(want)).sum())


# ---------------------------------------------------------------------------
# (a) flash attention with P in bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [77, 256])
def test_flash_with_bf16_probabilities_holds_bf16_tolerance(S):
    """qwen2-1.5b's heads (H=12, K=2, hd=128), causal, bf16 q/k/v."""
    H, K, hd = 12, 2, 128
    q, k, v = (_rand((1, S, H, hd), 1), _rand((1, S, K, hd), 2),
               _rand((1, S, K, hd), 3))
    got = flash_bf16_p(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want = jref.flash_attention_ref(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


# ---------------------------------------------------------------------------
# (b), (c) the SSD chunk in 3xTF32 and in single TF32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Q", [64, 256])
def test_ssd_chunk_in_3xtf32_holds_the_kernel_tolerance(Q):
    """mamba2-1.3b's head width (P=64, N=128), a few heads."""
    args = _ssd_inputs(2, 3, Q, 64, 128, seed=Q)
    y, s = ssd_chunk_emulated(mm_3xtf32, *(torch.from_numpy(a)
                                           for a in args))
    want_y, want_s = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **SSD_TOL)


def test_ssd_chunk_in_single_tf32_misses_the_kernel_tolerance():
    """The same shape as above at Q=256: one TF32 product per f32 one
    (10-bit mantissas) is far outside 1e-4, so the kernel splits."""
    args = _ssd_inputs(2, 3, 256, 64, 128, seed=256)
    t_args = [torch.from_numpy(a) for a in args]
    want_y, _ = jref.ssd_chunk_ref(*(jnp.asarray(a) for a in args))
    y1, _ = ssd_chunk_emulated(mm_tf32, *t_args)
    y3, _ = ssd_chunk_emulated(mm_3xtf32, *t_args)
    assert _violations(y1.numpy(), want_y, SSD_TOL) > 0
    assert _violations(y3.numpy(), want_y, SSD_TOL) == 0
    err1 = np.abs(y1.numpy() - np.asarray(want_y)).max()
    err3 = np.abs(y3.numpy() - np.asarray(want_y)).max()
    assert err1 > 100 * err3


# ---------------------------------------------------------------------------
# the bf16 flash wrapper's TMA checks (pure Python: run on CPU tensors)
# ---------------------------------------------------------------------------

def _fused(B, S, H, K, hd, pad=0):
    """q, k, v as views of one fused projection of width (H+2K)*hd+pad."""
    fused = torch.zeros(B, S, (H + 2 * K) * hd + pad, dtype=torch.bfloat16)
    q, k, v = fused[..., :(H + 2 * K) * hd].split(
        [H * hd, K * hd, K * hd], dim=-1)
    return (q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd),
            fused)


def test_tma_check_takes_views_of_a_fused_projection():
    q, k, v, _ = _fused(2, 50, 4, 2, 64)
    fa_kernel.check_tma_operands(q, k, v)          # raises on refusal
    fa_kernel.check_tma_operands(*(t.contiguous() for t in (q, k, v)))


def test_tma_check_refuses_a_misaligned_view():
    B, S, H, K, hd = 1, 16, 4, 2, 64
    fused = torch.zeros(B, S, (H + 2 * K) * hd + 4, dtype=torch.bfloat16)
    q = fused[..., 4:4 + H * hd].view(B, S, H, hd)     # 8 bytes in
    k = fused[..., H * hd:(H + K) * hd].view(B, S, K, hd)
    with pytest.raises(ValueError, match="aligned"):
        fa_kernel.check_tma_operands(q, k, k)


def test_tma_check_refuses_strides_off_the_16_byte_grid():
    q, k, v, _ = _fused(1, 16, 4, 2, 64, pad=4)        # seq stride % 8 == 4
    with pytest.raises(ValueError, match="strides"):
        fa_kernel.check_tma_operands(q, k, v)
    one_row = _fused(1, 1, 4, 2, 64, pad=4)[:3]        # S = 1: not read
    fa_kernel.check_tma_operands(*one_row)
