"""The numerical design of the tensor-core kernels, in plain torch on the
CPU, against the JAX package's oracles (``repro.kernels.ref``).

The card's kernels cannot run here, so these tests emulate their
arithmetic and show that it holds the gates the kernels are held to on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 2):

* flash attention, bf16: the probabilities P rounded to bf16 before
  P V (the A operand of the second wgmma), with Q K^T and P V summed in
  f32 over 64-key tiles and an online softmax, holds the bf16 tolerance
  3e-2 at qwen2-1.5b's heads;
* its backward, bf16: S, dP in f32 from bf16 operands, P and dS rounded
  to bf16 before dV = P^T dO, dK = dS^T Q and dQ = dS K (the A operands
  from registers), f32 sums, holds 3e-2 against ``jax.vjp`` of the
  reference attention; the dK/dV launch's work split, as the kernel
  computes it from its block index, covers every causal tile pair once
  and fills the card;
* the SSD chunk with every product in 3xTF32 (a = hi + lo, both TF32;
  a b = lo_a hi_b + hi_a lo_b + hi_a hi_b, summed in f32) holds the SSD
  kernel's 1e-4 at mamba2-1.3b's head width, while a single TF32 product
  misses it: that is why the kernel splits;
* its backward (csrc/ssd_bwd.cu), each operand split once as it is
  staged, its products in the kernel's tile and k-step order (the column
  pass's two halves of i summed apart and added at the end, dC over the
  j-tiles from the dG workspace), holds 1e-4 of each output's max |value|
  against ``jax.vjp`` of the reference; single TF32 misses it; both
  launches' work splits cover every causal tile pair once.

TF32 is emulated by zeroing the 13 low mantissa bits of an f32 through
an int32 view (the tensor cores read an f32 register that way); the
kernel rounds to nearest instead (cvt.rna), which is no less exact.
Inputs come from a numpy seed and go to both frameworks."""
import collections
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

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


def split_tf32_rn(a: torch.Tensor):
    """The backward kernel's split at staging: hi = a rounded to TF32
    (half a TF32 ulp added, the 13 low bits dropped), lo = a - hi in f32;
    the mma reads lo's TF32 part."""
    hi = ((a.contiguous().view(torch.int32) + 4096) & -8192).view(
        torch.float32)
    return hi, tf32(a - hi)


def mma_steps(a: torch.Tensor, b: torch.Tensor, three: bool,
              acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a @ b (a (..., M, K), b (..., K, N), K a multiple of 8) as
    mma.sync.m16n8k8 takes it: k-steps of 8 in order, each step's product
    a fresh f32 accumulator added to the running sum.  three: 3xTF32 from
    split operands (lo_a hi_b + hi_a lo_b + hi_a hi_b); else one TF32
    product."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        if three:
            ah, al = split_tf32_rn(ak)
            bh, bl = split_tf32_rn(bk)
            out = out + (al @ bh + ah @ bl + ah @ bh)
        else:
            out = out + tf32(ak) @ tf32(bk)
    return out


BWD_TILE = 64


def ssd_chunk_bwd_emulated(three, x, dt, cs, Bm, Cm, dy, dS):
    """ssd_chunk_bwd_ref's function as csrc/ssd_bwd.cu takes it: rows
    padded with zeros to whole 64-row tiles; pass (1) per j-tile, the
    state side, then the i-tiles at and below the diagonal, G = B_j C_i^T
    and dA = x_j dy_i^T, dx_j += att^T dy_i and dB_j += dG^T C_i over the
    i of each half (columns 0-31 and 32-63 of a tile) apart, the halves
    added at the end; pass (2) dC_i over the j-tiles from dG.  The sums
    for ddt and dcs in f32."""
    R, H, Q, P = x.shape
    N = Bm.shape[-1]
    T = BWD_TILE
    nt = -(-Q // T)
    Qp = nt * T
    pad = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, Qp - Q)))
    xp, dyp, Bp, Cp = pad(x), pad(dy), pad(Bm), pad(Cm)
    dtp, csp = (torch.nn.functional.pad(t, (0, Qp - Q)) for t in (dt, cs))
    rows = torch.arange(Qp)
    in_q = rows < Q
    e = torch.where(in_q, torch.exp(cs[..., -1:] - csp), 0.0)
    w = e * dtp
    dx, dB, dC = (torch.zeros(R, H, Qp, n) for n in (P, N, N))
    ddt, dcs, wu = (torch.zeros(R, H, Qp) for _ in range(3))
    dG = {}
    for jt in range(nt):
        J = slice(jt * T, jt * T + T)
        wj = w[..., J, None]
        xds = mma_steps(xp[..., J, :], dS.transpose(-1, -2), three)
        bds = mma_steps(Bp[..., J, :], dS, three)
        u = (Bp[..., J, :] * xds).sum(-1)
        wu[..., J] = w[..., J] * u
        half_dx = [torch.zeros(R, H, T, P), torch.zeros(R, H, T, P)]
        half_db = [torch.zeros(R, H, T, N), torch.zeros(R, H, T, N)]
        for h in range(2):
            half_db[h][..., 64 * h:64 * h + 64] = (wj * xds)[
                ..., 64 * h:64 * h + 64]
            half_dx[h][..., 32 * h:32 * h + 32] = (wj * bds)[
                ..., 32 * h:32 * h + 32]
        ddt_j = e[..., J] * u
        dcs_j = -torch.where(rows[J] != Q - 1, wu[..., J], 0.0)
        for it in range(jt, nt):
            I = slice(it * T, it * T + T)
            G = mma_steps(Bp[..., J, :], Cp[..., I, :].transpose(-1, -2),
                          three)                              # (j, i)
            dA = mma_steps(xp[..., J, :], dyp[..., I, :].transpose(-1, -2),
                           three)
            keep = (rows[I][None, :] >= rows[J][:, None]) & in_q[I][None, :]
            lm = torch.where(keep, torch.exp(
                csp[..., None, I] - csp[..., J, None]), 0.0)
            ld = lm * dtp[..., J, None]
            att, dg = G * ld, dA * ld
            off = rows[I][None, :] != rows[J][:, None]
            pm = torch.where(off, dA * att, 0.0)
            ddt_j = ddt_j + (dA * G * lm).sum(-1)
            dcs_j = dcs_j - pm.sum(-1)
            dcs[..., I] += pm.sum(-2)
            for h in range(2):
                cols = slice(32 * h, 32 * h + 32)
                half_dx[h] = mma_steps(att[..., cols], dyp[..., I, :][
                    ..., cols, :], three, half_dx[h])
                half_db[h] = mma_steps(dg[..., cols], Cp[..., I, :][
                    ..., cols, :], three, half_db[h])
            dG[jt, it] = dg
        dx[..., J, :] = half_dx[0] + half_dx[1]
        dB[..., J, :] = half_db[0] + half_db[1]
        ddt[..., J] = ddt_j
        dcs[..., J] += dcs_j
    for it in range(nt):
        I = slice(it * T, it * T + T)
        acc = torch.zeros(R, H, T, N)
        for jt in range(it + 1):
            J = slice(jt * T, jt * T + T)
            acc = mma_steps(dG[jt, it].transpose(-1, -2), Bp[..., J, :],
                            three, acc)
        dC[..., I, :] = acc
    dcs[..., Q - 1] += wu[..., :Q - 1].sum(-1)
    return (dx[..., :Q, :], ddt[..., :Q], dcs[..., :Q], dB[..., :Q, :],
            dC[..., :Q, :])


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


def flash_bwd_bf16(q, k, v, o, lse, do, causal=True):
    """The bf16 backward kernels' arithmetic: q, k, v, o, do bf16, lse
    f32 -> (dq, dk, dv) bf16.  S = Q K^T and dP = dO V^T in f32; P =
    exp2(S scale log2 e - lse log2 e) under the top-left mask; D = rowsum(P
    dP) (its own launch, not rowsum(dO O) of the bf16 o, which is not
    read); dS = P (dP - D) from the f32 P; then P and dS rounded to bf16
    before the three products, which sum in f32; each output rounded
    once."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    log2e = 1.4426950408889634
    grp = (lambda t: t.float().reshape(B, Sq, K, G, hd))
    qg, dog = grp(q), grp(do)
    kf, vf = k.float(), v.float()
    lse2 = (lse.float() * log2e).reshape(B, K, G, Sq)
    s = torch.einsum("bskgh,btkh->bkgst", qg, kf)
    p = torch.exp2(s * (scale * log2e) - lse2[..., None])
    if causal:
        p = p.masked_fill(~torch.ones(Sq, Skv, dtype=torch.bool).tril(), 0.0)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, vf)
    d = (p * dp).sum(-1)                                    # (B,K,G,Sq)
    ds = p * (dp - d[..., None])
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgst,bskgh->btkh", p16, dog)
    dk = torch.einsum("bkgst,bskgh->btkh", ds16, qg) * scale
    dq = torch.einsum("bkgst,btkh->bskgh", ds16, kf) * scale
    return (dq.reshape(B, Sq, H, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


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
# the flash backward with P and dS in bf16, and its work split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", [
    (1, 64, 64, 2, 2, 16, True),          # G = 1
    (2, 77, 77, 4, 2, 64, True),          # G = 2, ragged S
    (1, 130, 130, 12, 2, 128, True),      # qwen2-1.5b's heads, G = 6
    (1, 77, 77, 6, 1, 16, True),          # G = 6
    (2, 64, 64, 6, 3, 128, True),         # G = 2
    (1, 130, 130, 3, 3, 64, True),        # G = 1, ragged S
    (1, 200, 200, 6, 1, 64, True),        # G = 6, four 64-row tiles
    (1, 50, 130, 4, 2, 128, False),       # non-causal, ragged Skv
    (2, 130, 33, 6, 1, 16, False)])       # non-causal, Skv < Sq
def test_flash_bwd_with_bf16_p_and_ds_holds_bf16_tolerance(B, Sq, Skv, H, K,
                                                           hd, causal):
    """The emulated kernels against jax.vjp of the JAX package's
    reference attention on the same bf16-rounded inputs, in f32."""
    arrs = [_rand(shape, seed) for shape, seed in (
        ((B, Sq, H, hd), 11), ((B, Skv, K, hd), 12), ((B, Skv, K, hd), 13),
        ((B, Sq, H, hd), 14))]
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in arrs)
    # the forward's outputs as the card's forward gives them: o in bf16
    # from P in bf16, lse in f32
    o = (flash_bf16_p(q, k, v, causal) if causal else
         tref.flash_attention_ref(q, k, v, causal=False))
    lse = tref.flash_attention_lse_ref(q, k, v, causal)
    got = flash_bwd_bf16(q, k, v, o, lse, do, causal)
    f32 = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal),
                     *f32[:3])
    for g, w in zip(got, vjp(f32[3])):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), **BF16)


def test_flash_bwd_takes_d_from_p_where_keys_share_a_large_mean():
    """Cross-attention over keys and values with a large common part
    (whisper-base's decoder over 1500 encoder states): o is then about
    the values' mean, and its bf16 rounding puts D = rowsum(dO o) off by
    more than the spread of dP that dS = P (dP - D) keeps, so sum_j dS_j
    is off zero and dQ = sum_j dS_j K_j carries that times the keys'
    mean.  D = rowsum(P dP), as the kernels take it, keeps dQ several
    times closer to f32 (jax.vjp of the reference)."""
    B, Sq, Skv, H, hd = 1, 64, 1500, 2, 64
    rng = np.random.default_rng(21)
    q, do = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = ((4.0 * rng.standard_normal(hd)
             + rng.standard_normal((B, Skv, H, hd))).astype(np.float32)
            for _ in range(2))
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o = flash_bf16_p(q, k, v, causal=False)
    lse = tref.flash_attention_lse_ref(q, k, v, False)
    f32 = [jnp.asarray(t.float().numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, False),
                     *f32[:3])
    want = np.asarray(vjp(f32[3])[0])

    def err(dq):
        return float(np.linalg.norm(dq.float().numpy() - want)
                     / np.linalg.norm(want))
    got = err(flash_bwd_bf16(q, k, v, o, lse, do, causal=False)[0])
    # the same arithmetic with D = rowsum(dO O) of the bf16 o
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.einsum("bshd,bthd->bhst", do.float(), v.float())
    d = (do.float() * o.float()).sum(-1).permute(0, 2, 1)
    ds = (p * (dp - d[..., None])).bfloat16().float()
    from_o = err(torch.einsum("bhst,bthd->bshd", ds, k.float()) * scale)
    assert got < 0.02 and from_o > 3 * got, (got, from_o)


def dkdv_work(B, H, K, Sq, Skv, causal=True):
    """The bf16 dK/dV launch's work split, from the index math of
    ``flash_bwd_dkdv_tc`` (csrc/flash_attention_bwd.cu): one list per
    block, in launch order (grid (K * C, B, key tiles), x fastest), of
    the (batch, q-head, key tile, q tile) pairs of 64 x 64 it multiplies,
    with C = ``dkdv_cluster(G)`` as the wrapper passes it."""
    G = H // K
    C = fa_kernel.dkdv_cluster(G)
    tiles = (lambda n: -(-n // 64))
    blocks = []
    for z in range(tiles(Skv)):                  # grid.z: the key tile
        first = z if causal else 0
        for b in range(B):                       # grid.y
            for x in range(K * C):               # grid.x: kv-head, rank
                kvh, rank = divmod(x, C)
                blocks.append([(b, kvh * G + rank + i * C, z, t)
                               for i in range(G // C)
                               for t in range(first, tiles(Sq))])
    return blocks


def _causal_pairs(B, H, n_q, n_k, causal):
    """(batch, q-head, key tile, q tile) of every 64 x 64 tile pair with
    a visible key: q tile t meets key tile z iff t >= z under the mask."""
    return {(b, h, z, t) for b in range(B) for h in range(H)
            for z in range(n_k) for t in range(n_q) if not causal or t >= z}


@pytest.mark.parametrize("B,Sq,Skv,H,K,causal", [
    (2, 1024, 1024, 12, 2, True),         # qwen2-1.5b's training shape
    (1, 995, 995, 12, 2, True),           # ragged
    (1, 300, 300, 12, 1, True),           # G = 12: two heads a block
    (1, 70, 70, 11, 1, True),             # G = 11: one block, all heads
    (2, 50, 130, 8, 1, False)])           # non-causal, ragged
def test_dkdv_work_covers_every_tile_pair_once(B, Sq, Skv, H, K, causal):
    blocks = dkdv_work(B, H, K, Sq, Skv, causal)
    seen = collections.Counter(pair for blk in blocks for pair in blk)
    assert set(seen.values()) == {1}
    assert set(seen) == _causal_pairs(B, H, -(-Sq // 64), -(-Skv // 64),
                                      causal)
    # a block's heads share its kv-head: the partial dK/dV it sums are one
    # kv-head's
    G = H // K
    assert all(len({h // G for _, h, _, _ in blk}) == 1 for blk in blocks)


def test_dkdv_work_fills_the_card_longest_first():
    """At qwen2-1.5b's training shape the dK/dV launch has more blocks
    than the H100's 132 SMs, none with more than twice the mean work, and
    the longest blocks launch first."""
    blocks = dkdv_work(2, 12, 2, 1024, 1024, True)
    work = [len(b) for b in blocks]
    assert len(blocks) >= 132
    assert max(work) <= 2.0 * (sum(work) / len(work))
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("G,C", [(1, 1), (2, 2), (3, 3), (6, 6), (8, 8),
                                 (9, 3), (11, 1), (12, 6), (16, 8)])
def test_dkdv_cluster_is_the_largest_divisor_up_to_eight(G, C):
    assert fa_kernel.dkdv_cluster(G) == C


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
# the SSD chunk's backward in 3xTF32, split at staging, and its work split
# ---------------------------------------------------------------------------

SSD_BWD_TOL = 1e-4            # of each output's max |value|: chip_smoke.py's


def _ssd_bwd_case(R, H, Q, P, N, seed):
    """Forward inputs as tests/test_kernels.py draws them, incoming dy and
    dS; the emulated kernel's gradients and jax.vjp's of the reference."""
    args = _ssd_inputs(R, H, Q, P, N, seed)
    dy, dS = _rand((R, H, Q, P), seed + 5), _rand((R, H, N, P), seed + 6)
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *(jnp.asarray(a) for a in args))
    want = [np.array(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]
    t_args = [torch.from_numpy(a) for a in (*args, dy, dS)]
    # The reference's own dcs is NaN wherever its decay overflows above
    # the diagonal (exp(cs_i - cs_j) past f32 times a masked 0: ROADMAP
    # section 3's caveat; at Q = 256 every row).  There the f64 closed
    # form stands in, ref.ssd_chunk_bwd_ref, held to jax.vjp where both
    # are finite by tests/test_torch_grad.py.
    f64 = tref.ssd_chunk_bwd_ref(*(t.double() for t in t_args))
    for w, alt in zip(want, f64):
        bad = ~np.isfinite(w)
        w[bad] = alt.numpy()[bad]
    return t_args, want


def _err_over_max(got, want):
    """max |got - want| / max |want| of each output, all finite."""
    assert all(bool(torch.isfinite(g).all()) for g in got)
    return [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("R,H,Q", [(1, 2, 256), (2, 1, 77)])
def test_ssd_bwd_in_3xtf32_split_at_staging_holds_the_gate(R, H, Q):
    """mamba2-1.3b's heads (P=64, N=128): a few (chunk, head) tiles of a
    whole chunk (Q=256, four 64-row tiles, ten pairs) and of a short one
    (Q=77): every output within 1e-4 of its max |value| of jax.vjp."""
    t_args, want = _ssd_bwd_case(R, H, Q, 64, 128, seed=Q + R)
    got = ssd_chunk_bwd_emulated(True, *t_args)
    errs = _err_over_max(got, want)
    assert max(errs) <= SSD_BWD_TOL, errs


def test_ssd_bwd_in_single_tf32_misses_the_gate():
    """The same design with one TF32 product per f32 one: far outside
    1e-4, while 3xTF32 is well inside it."""
    t_args, want = _ssd_bwd_case(1, 2, 256, 64, 128, seed=257)
    errs1 = _err_over_max(ssd_chunk_bwd_emulated(False, *t_args), want)
    errs3 = _err_over_max(ssd_chunk_bwd_emulated(True, *t_args), want)
    assert max(errs1) > SSD_BWD_TOL
    assert max(errs3) <= SSD_BWD_TOL
    assert max(errs1) > 20 * max(errs3)


def ssd_bwd_work(R, H, Q):
    """The SSD backward's two launches from their index math
    (csrc/ssd_bwd.cu): per block, in launch order, the (r, h, j-tile,
    i-tile) pairs it takes, and for pass (1) the workspace slot it writes
    each pair's dG to (pass (2) reads the same slots)."""
    T = -(-Q // BWD_TILE)
    RH = R * H
    cols, rows = [], []
    for b in range(T * RH):                 # ssd_bwd_cols
        jt, rh = divmod(b, RH)
        cols.append([(rh, jt, it, it * (it + 1) // 2 + jt)
                     for it in range(jt, T)])
    for b in range(T * RH):                 # ssd_bwd_rows
        k, rh = divmod(b, RH)
        it = T - 1 - k
        rows.append([(rh, jt, it, it * (it + 1) // 2 + jt)
                     for jt in range(it + 1)])
    return cols, rows


@pytest.mark.parametrize("R,H,Q", [(8, 64, 256), (1, 4, 77), (1, 3, 1),
                                   (2, 5, 200)])
def test_ssd_bwd_work_covers_every_causal_tile_pair_once(R, H, Q):
    """Each launch takes every (r, h, j-tile, i-tile) pair at or below the
    diagonal (i-tile >= j-tile) exactly once; each pair has its own workspace slot, the same in
    both launches; blocks with more pairs launch first."""
    T = -(-Q // BWD_TILE)
    pairs = {(rh, jt, it) for rh in range(R * H) for jt in range(T)
             for it in range(jt, T)}
    for blocks in ssd_bwd_work(R, H, Q):
        seen = collections.Counter(p[:3] for blk in blocks for p in blk)
        assert set(seen.values()) == {1} and set(seen) == pairs
        slots = {p[:3]: p[3] for blk in blocks for p in blk}
        assert sorted(set((rh, s) for (rh, _, _), s in slots.items())) == \
            [(rh, s) for rh in range(R * H) for s in range(T * (T + 1) // 2)]
        work = [len(blk) for blk in blocks]
        assert work == sorted(work, reverse=True)
    cols, rows = ssd_bwd_work(R, H, Q)
    assert ({p for blk in cols for p in blk}
            == {p for blk in rows for p in blk})


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


def test_bwd_tma_check_takes_views_of_a_fused_projection_and_do():
    """The backward's check covers dO, the fourth operand it reads
    through TMA; q, k, v as views of one fused projection pass."""
    q, k, v, _ = _fused(2, 50, 4, 2, 64)
    do = torch.zeros(q.shape, dtype=torch.bfloat16)
    fa_kernel.check_tma_operands(q, k, v, do)          # raises on refusal


def test_bwd_tma_check_refuses_a_misaligned_do():
    q, k, v, _ = _fused(1, 16, 4, 2, 64)
    buf = torch.zeros(q.numel() + 4, dtype=torch.bfloat16)
    do = buf[4:].view(q.shape)                         # 8 bytes in
    with pytest.raises(ValueError, match="do 16-byte aligned"):
        fa_kernel.check_tma_operands(q, k, v, do)
