"""repro_torch's CUDA kernels vs their plain versions, on the card.

Every test here is marked ``cuda`` and skips, from inside the test, where
torch sees no GPU.  On a machine with one (and without JAX):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: f32 atol 2e-5 / rtol 1e-4 for attention and 1e-5 for
rmsnorm (sums in another order, no TF32); bf16 3e-2 (the bf16 kernel
rounds the probabilities to bf16 before P V, and the output once); SSD
and the f32 mamba prefill 1e-4 (tests/test_kernels.py's for the SSD
kernel, whose 3xTF32 products keep f32's accuracy).  The backward
kernels: f32 atol 1e-4 / rtol 1e-4 (sums of up to G * S products in
another order), bf16 3e-2 (P and dS rounded to bf16 before their
products, as the forward rounds P, and one rounding of each output); the
forward's log-sum-exp atol 1e-4 / rtol 1e-4; the SSD backward every
output within 1e-4 of its max |value| (f32 sums of up to Q products in
another order); the gated norm's backward as the other norms'; model
gradients per leaf within 1e-4 of the leaf's max |g| (f32)."""
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
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", [
    (1, 63, 63, 12, 2, 128, True), (1, 64, 64, 12, 2, 128, True),
    (1, 65, 65, 12, 2, 128, True), (1, 129, 129, 12, 2, 128, True),
    (1, 995, 995, 12, 2, 128, True),             # the qwen2-1.5b probe
    (2, 100, 100, 4, 2, 16, True), (2, 100, 100, 4, 2, 32, True),
    (2, 100, 100, 4, 2, 64, True), (2, 100, 100, 4, 2, 128, True),
    (2, 50, 130, 4, 2, 128, False), (1, 130, 50, 6, 3, 32, False)])
def test_flash_bf16_tensor_core_kernel_matches_plain(cuda, B, Sq, Skv, H, K,
                                                     hd, causal):
    """The wgmma kernel at its 64-row/64-key tile edges, every head
    width, and non-causal Sq != Skv."""
    q = _rand((B, Sq, H, hd), 30, torch.bfloat16, cuda)
    k = _rand((B, Skv, K, hd), 31, torch.bfloat16, cuda)
    v = _rand((B, Skv, K, hd), 32, torch.bfloat16, cuda)
    n = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal), BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 128])
def test_flash_bf16_kernel_takes_strided_heads(cuda, hd):
    """bf16 q/k/v as views of one fused projection: the TMA tensor maps
    take its seq stride (H + 2K) * hd as it is."""
    B, S, H, K = 2, 70, 4, 2
    fused = _rand((B, S, (H + 2 * K) * hd), 33, torch.bfloat16, cuda)
    q, k, v = fused.split([H * hd, K * hd, K * hd], dim=-1)
    q, k, v = (q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd))
    _assert_close(ops.flash_attention(q, k, v),
                  ref.flash_attention_ref(q, k, v), BF16)


@pytest.mark.cuda
def test_flash_bf16_kernel_refuses_misaligned_views(cuda):
    """TMA needs 16-byte aligned bases and strides: a view 8 bytes in, or
    a seq stride of 516 elements, is refused, never copied."""
    B, S, H, K, hd = 1, 16, 4, 2, 64
    fused = _rand((B, S, (H + 2 * K) * hd + 4), 34, torch.bfloat16, cuda)
    k = fused[..., H * hd:(H + K) * hd].view(B, S, K, hd)
    n = ops.flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(fused[..., 4:4 + H * hd].view(B, S, H, hd), k, k)
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention(fused[..., :H * hd].view(B, S, H, hd), k, k)
    assert ops.flash_attention.launches == n


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


@pytest.mark.cuda
@pytest.mark.parametrize("R,H,Q,P,N,shared", [
    (2, 4, 128, 64, 32, True),      # small, B/C shared by the heads
    (1, 3, 77, 16, 8, False),       # ragged Q, one chunk, N below a tile
    (3, 2, 200, 32, 130, True),     # ragged Q over 4 i-tiles, N over 3 tiles
    (1, 64, 1, 64, 128, True),      # one token at mamba2-1.3b's heads
    (4, 64, 256, 64, 128, True),    # the serving path's main shape
    (1, 64, 255, 64, 128, True)])   # one row short of four full i-tiles
def test_ssd_kernel_matches_plain(cuda, R, H, Q, P, N, shared):
    x = _rand((R, H, Q, P), 10, torch.float32, cuda)
    dt = torch.nn.functional.softplus(_rand((R, H, Q), 11, torch.float32,
                                            cuda))
    A = -torch.exp(_rand((H,), 12, torch.float32, cuda))
    cs = torch.cumsum(dt * A[None, :, None], dim=-1)
    G = 1 if shared else H
    Bm = _rand((R, G, Q, N), 13, torch.float32, cuda).expand(R, H, Q, N)
    Cm = _rand((R, G, Q, N), 14, torch.float32, cuda).expand(R, H, Q, N)
    n = ops.ssd_chunk_kernel.launches
    y, s = ops.ssd_chunk_kernel(x, dt, cs, Bm, Cm)
    torch.cuda.synchronize()
    assert ops.ssd_chunk_kernel.launches == n + 1
    assert y.shape == (R, H, Q, P) and s.shape == (R, H, N, P)
    want_y, want_s = ref.ssd_chunk_ref(x, dt, cs, Bm, Cm)
    _assert_close(y, want_y, dict(atol=1e-4, rtol=1e-4))
    _assert_close(s, want_s, dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x = _rand((1, 2, 8, 16), 15, torch.float32, cuda)
    dt = _rand((1, 2, 8), 16, torch.float32, cuda)
    Bm = _rand((1, 2, 8, 8), 17, torch.float32, cuda)
    with pytest.raises(TypeError):
        ops.ssd_chunk_kernel(x.bfloat16(), dt, dt, Bm, Bm)
    x_strided = _rand((1, 2, 16, 8), 18, torch.float32, cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_chunk_kernel(x_strided, dt, dt, Bm, Bm)


def _ssd_bwd_inputs(R, H, Q, P, N, shared, cuda, seed=20):
    x = _rand((R, H, Q, P), seed, torch.float32, cuda)
    dt = torch.nn.functional.softplus(_rand((R, H, Q), seed + 1,
                                            torch.float32, cuda))
    A = -torch.exp(_rand((H,), seed + 2, torch.float32, cuda))
    cs = torch.cumsum(dt * A[None, :, None], dim=-1)
    G = 1 if shared else H
    Bm = _rand((R, G, Q, N), seed + 3, torch.float32, cuda).expand(R, H, Q, N)
    Cm = _rand((R, G, Q, N), seed + 4, torch.float32, cuda).expand(R, H, Q, N)
    dy = _rand((R, H, Q, P), seed + 5, torch.float32, cuda)
    dS = _rand((R, H, N, P), seed + 6, torch.float32, cuda)
    return x, dt, cs, Bm, Cm, dy, dS


@pytest.mark.cuda
@pytest.mark.parametrize("R,H,Q,P,N,shared", [
    (8, 64, 256, 64, 128, True),    # mamba2-1.3b's training shape
    (1, 64, 77, 64, 128, True),     # a short chunk
    (1, 64, 1, 64, 128, True),      # one token
    (2, 64, 256, 64, 128, True),    # chip_smoke.py's SSD_BWD_CASES, B/C
    (8, 64, 256, 64, 128, False),   # shared and per head
    (1, 64, 77, 64, 128, False),
    (1, 64, 1, 64, 128, False),
    (2, 64, 256, 64, 128, False),
    (2, 3, 200, 16, 8, False),      # ragged over 4 tiles, per-head B/C
    (1, 2, 130, 5, 7, True),        # P and N off every granule
    (1, 4, 64, 64, 128, False)])    # one whole tile
def test_ssd_bwd_kernel_matches_plain(cuda, R, H, Q, P, N, shared):
    args = _ssd_bwd_inputs(R, H, Q, P, N, shared, cuda)
    n = ops.ssd_chunk_bwd.launches
    got = ops.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    assert ops.ssd_chunk_bwd.launches == n + 1
    want = ref.ssd_chunk_bwd_ref(*args)
    for name, g, w in zip(("dx", "ddt", "dcs", "dB", "dC"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Q,shared", [(2, 256, True), (8, 256, True),
                                        (1, 77, False)])
def test_ssd_bwd_kernel_is_deterministic(cuda, R, Q, shared):
    """Two launches on the same inputs give the same bits (one writer an
    output, sums in a fixed order, no atomics)."""
    args = _ssd_bwd_inputs(R, 64, Q, 64, 128, shared, cuda, seed=30)
    a, b = ops.ssd_chunk_bwd(*args), ops.ssd_chunk_bwd(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_ssd_bwd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, cs, Bm, Cm, dy, dS = _ssd_bwd_inputs(1, 2, 8, 65, 8, False, cuda)
    with pytest.raises(ValueError, match="P <= 64"):
        ops.ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy, dS)
    x, dt, cs, Bm, Cm, dy, dS = _ssd_bwd_inputs(1, 2, 8, 16, 8, False, cuda)
    with pytest.raises(ValueError, match="dy"):
        ops.ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy[..., :8], dS)
    with pytest.raises(TypeError):
        ops.ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy.double(), dS)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [5, 77, 300])
def test_mamba_prefill_kernel_path_matches_plain(cuda, S):
    """A small f32 mamba2 prefill (chunk 64, so 300 tokens take five
    chunks with a short last one) on the kernel path against the plain
    path: logits and the cached states."""
    from repro_torch.models import api, get_config
    cfg = get_config("mamba2-1.3b-smoke").replace(ssm_chunk=64)
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, S), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(S))
    outs = []
    n = ops.ssd_chunk_kernel.launches
    for c in (cfg, cfg.replace(use_kernels=False)):
        cache = api.init_cache(c, 2, S, device=cuda)
        outs.append(api.prefill(params, c, cache, {"tokens": toks}))
    assert ops.ssd_chunk_kernel.launches == n + cfg.num_layers
    (got, got_c), (want, want_c) = outs
    _assert_close(got, want, dict(atol=1e-4, rtol=1e-4))
    for key in ("ssm", "conv"):
        _assert_close(got_c[key], want_c[key], dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W,K", [(128, 64, 3), (256, 128, 5), (100, 70, 3),
                                   (1000, 1000, 3), (33, 65, 5), (1, 1, 3),
                                   (2, 200, 5)])
def test_stencil_kernel_matches_plain(cuda, dtype, H, W, K):
    """f32 atol 1e-5: the same products in the same (dy, dx) order, the
    kernel's contracted into FMAs; bf16 3e-2: one rounding of the output."""
    dt = getattr(torch, dtype)
    img, kern = _rand((H, W), 20, dt, cuda), _rand((K, K), 21, dt, cuda)
    n = ops.stencil2d.launches
    got = ops.stencil2d(img, kern)
    torch.cuda.synchronize()
    assert ops.stencil2d.launches == n + 1
    assert got.dtype == dt and got.shape == (H, W)
    _assert_close(got, ref.stencil2d_ref(img, kern),
                  dict(atol=1e-5, rtol=0) if dtype == "float32" else BF16)


@pytest.mark.cuda
def test_stencil_kernel_refuses_what_it_does_not_take(cuda):
    img = _rand((16, 16), 22, torch.float32, cuda)
    kern = _rand((3, 3), 23, torch.float32, cuda)
    with pytest.raises(TypeError):
        ops.stencil2d(img.half(), kern)
    with pytest.raises(ValueError, match="contiguous"):
        ops.stencil2d(_rand((16, 32), 24, torch.float32, cuda).T, kern)
    with pytest.raises(ValueError, match="K in"):
        ops.stencil2d(img, _rand((7, 7), 25, torch.float32, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("L,size,dist,offset", [
    (2048, 2, 1, 0), (2048, 8, 4, 0), (2048, 64, 16, 0),
    (2048, 2048, 256, 0), (131072, 1024, 512, 0),
    (32768, 131072, 1024, 65536), (32768, 65536, 4, 32768),
    (4096, 8, 8, 0)])                     # size == dist: the ref's quirk
def test_bitonic_kernel_matches_plain(cuda, dtype, L, size, dist, offset):
    if dtype == "int32":
        x = torch.randint(-1000, 1000, (L,), device=cuda, dtype=torch.int32,
                          generator=torch.Generator(cuda).manual_seed(L))
    else:
        x = _rand((L,), 26, torch.float32, cuda)
    n = ops.bitonic_stage.launches
    got = ops.bitonic_stage(x, dist, size, offset=offset)
    torch.cuda.synchronize()
    assert ops.bitonic_stage.launches == n + 1
    torch.testing.assert_close(
        got, ref.bitonic_stage_ref(x, dist, size, offset), rtol=0, atol=0)


@pytest.mark.cuda
def test_bitonic_kernel_refuses_what_it_does_not_take(cuda):
    x = _rand((4096,), 27, torch.float32, cuda)
    for bad in (x.bfloat16(), x.half(), x.double()):
        with pytest.raises(TypeError):
            ops.bitonic_stage(bad, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitonic_stage(_rand((8192,), 28, torch.float32, cuda)[::2], 4, 8)
    with pytest.raises(ValueError, match="dist"):
        ops.bitonic_stage(x, 2048, 4096)                 # dist >= block


@pytest.mark.cuda
@pytest.mark.parametrize("name,size,launches", [
    ("sc", 512, {"stencil2d": 4}),
    ("bs", 16384, {"bitonic_stage": 4 * 3, "bitonic_block": 4 * 4})])
def test_dmode_on_a_four_shard_card_mesh(cuda, name, size, launches):
    """SC and BS D-mode on [cuda] * 4 against the numpy oracle, their
    kernels launched once per shard (SC), and per shard once for each
    stage with 2048 <= dist < 4096 and once for each run of in-tile
    stages (BS, shards of 4096: 3 stages, 4 block launches)."""
    from repro_torch.launch import mgmark
    from repro_torch.patterns import WORKLOADS, Mesh, evaluate
    mod = WORKLOADS[name]
    mesh = Mesh([cuda] * 4)
    args, oracle = mgmark.workload_inputs(name, size)
    rep = evaluate(name, mod.PATTERN, "dmode", mod.make_dmode(mesh), args,
                   oracle, mesh)
    assert rep.correct and rep.max_err <= 1e-5
    assert {k: v for k, v in rep.launches.items() if v} == launches
    assert rep.device.startswith("cuda")


# ---------------------------------------------------------------------------
# the fused norms, the bitonic block kernel, and the refusal of grad
# ---------------------------------------------------------------------------

FUSED_NORM_SHAPES = [(1, 1536), (4, 1536), (995, 1536), (4, 2048),
                     (1, 4096), (4, 4096), (995, 4096),
                     (3, 100),            # off the 16-byte grid: scalar path
                     (2, 8200)]           # wider than the registers hold


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", FUSED_NORM_SHAPES)
def test_add_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    """h bit-equal to the eager x + r; out within f32 2e-5 / bf16 3e-2."""
    dt = getattr(torch, dtype)
    x, r = _rand((rows, d), 40, dt, cuda), _rand((rows, d), 41, dt, cuda)
    w = 1 + 0.1 * _rand((d,), 42, dt, cuda)
    n = ops.add_rmsnorm.launches
    h, out = ops.add_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    assert ops.add_rmsnorm.launches == n + 1
    want_h, want = ref.add_rmsnorm_ref(x, r, w)
    assert h.dtype == out.dtype == dt and torch.equal(h, want_h)
    _assert_close(out, want, F32 if dtype == "float32" else BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", FUSED_NORM_SHAPES)
def test_gated_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    dt = getattr(torch, dtype)
    x, z = _rand((rows, d), 43, dt, cuda), _rand((rows, d), 44, dt, cuda)
    w = 1 + 0.1 * _rand((d,), 45, dt, cuda)
    n = ops.gated_rmsnorm.launches
    out = ops.gated_rmsnorm(x, z, w)
    torch.cuda.synchronize()
    assert ops.gated_rmsnorm.launches == n + 1
    assert out.dtype == dt and out.shape == x.shape
    _assert_close(out, ref.gated_rmsnorm_ref(x, z, w),
                  F32 if dtype == "float32" else BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(2048, 4096), (1, 4096), (995, 4096),
                                    (37, 1536), (3, 100), (300, 64),
                                    (333, 4000), (5, 2056), (3, 8192),
                                    (2, 8200)])
def test_gated_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d):
    """mamba2-1.3b's training rows (the gate's own kernel: d = 4096), the
    same kernel at ragged widths (4000, 2056) and at its widest (8192 in
    bf16), rows a warp's registers hold (d = 1536, 64), an odd width (the
    scalar path) and one wider than the gate kernel takes (8200)."""
    dt = getattr(torch, dtype)
    x, z = _rand((rows, d), 46, dt, cuda), 2 * _rand((rows, d), 47, dt, cuda)
    w = (1 + 0.1 * _rand((d,), 48, torch.float32, cuda)).to(dt)
    dy = _rand((rows, d), 49, dt, cuda)
    n = ops.gated_rmsnorm_bwd.launches
    got = ops.gated_rmsnorm_bwd(x, z, w, dy)
    torch.cuda.synchronize()
    assert ops.gated_rmsnorm_bwd.launches == n + 1
    want = ref.gated_rmsnorm_bwd_ref(x, z, w, dy)
    tol = BWD_F32 if dtype == "float32" else BF16
    assert all(g.dtype == dt for g in got)
    _assert_close(got[0], want[0], tol)
    _assert_close(got[1], want[1], tol)
    scale = float(want[2].float().abs().max())
    _assert_close(got[2], want[2], dict(atol=tol["atol"] * max(1.0, scale),
                                        rtol=tol["rtol"]))
    a, b = ops.gated_rmsnorm_bwd(x, z, w, dy), got
    assert all(torch.equal(u, v) for u, v in zip(a, b))      # deterministic


@pytest.mark.cuda
def test_fused_kernels_refuse_what_they_do_not_take(cuda):
    x = _rand((4, 64), 46, torch.float32, cuda)
    with pytest.raises(ValueError, match="shape"):
        ops.add_rmsnorm(x, x[:2], x[0])
    with pytest.raises(TypeError):
        ops.gated_rmsnorm(x, x.bfloat16(), x[0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.add_rmsnorm(x, _rand((64, 4), 47, torch.float32, cuda).T, x[0])
    y = _rand((4096,), 47, torch.float32, cuda)
    with pytest.raises(ValueError, match="offset"):
        ops.bitonic_block(y, 4096, offset=1024)
    with pytest.raises(TypeError):
        ops.bitonic_block(y.bfloat16(), 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("L,size,block,offset", [
    (131072, 2048, 2048, 0),       # BS's first launch: phases 2..2048
    (131072, 131072, 2048, 0),     # the last phase's tail
    (131072, 8192, 2048, 0),
    (32768, 65536, 2048, 32768),   # a D-mode shard, phase above the shard
    (32768, 4096, 2048, 65536),
    (4096, 16, 2048, 0),           # phases 2..16 only
    (1024, 512, 256, 0),           # a smaller tile
    (2048, 2, 2, 0)])
def test_bitonic_block_kernel_matches_plain(cuda, dtype, L, size, block,
                                            offset):
    if dtype == "int32":
        x = torch.randint(-1000, 1000, (L,), device=cuda, dtype=torch.int32,
                          generator=torch.Generator(cuda).manual_seed(L))
    else:
        x = _rand((L,), 48, torch.float32, cuda)
    n = ops.bitonic_block.launches
    got = ops.bitonic_block(x, size, block, offset=offset)
    torch.cuda.synchronize()
    assert ops.bitonic_block.launches == n + 1
    torch.testing.assert_close(
        got, ref.bitonic_block_ref(x, size, min(block, L), offset),
        rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 2048, 131072])
def test_bs_sort_runs_no_plain_stage_on_the_card(cuda, L, monkeypatch):
    """U-mode's sort on the card: equal to torch.sort, in 21 stage and 7
    block launches at 131072, and the plain stage never called."""
    from repro_torch.patterns import bs

    def refuse(*args, **kwargs):
        raise AssertionError("the plain stage ran on the card")
    monkeypatch.setattr(ref, "bitonic_stage_ref", refuse)
    x = _rand((L,), 49, torch.float32, cuda)
    before = ops.launch_counts()
    got = bs.sort(x)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.sort(x).values)
    after = ops.launch_counts()
    steps = list(bs._steps(L, min(bs.BLOCK, L)))
    assert after["bitonic_stage"] - before["bitonic_stage"] == \
        sum(s[0] == "stage" for s in steps) == (21 if L == 131072 else 0)
    assert after["bitonic_block"] - before["bitonic_block"] == \
        sum(s[0] == "block" for s in steps) == (7 if L == 131072 else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [32, 37])
def test_mamba_grads_through_the_kernels_match_plain(cuda, S):
    """mamba2-1.3b-smoke in f32 (Q = 8; S = 37 pads the last chunk):
    every leaf's gradient through the SSD and gated-norm backward kernels
    matches the plain path's, each backward kernel ran once per forward
    call, and under no_grad the kernel path launches no backward."""
    from repro_torch.models import api, get_config
    cfg = get_config("mamba2-1.3b-smoke")
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, S + 1), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    ops.reset_launches()
    loss, got = _qwen_smoke_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    L = cfg.num_layers
    assert counts == {"ssd_chunk_kernel": L, "ssd_chunk_bwd": L,
                      "gated_rmsnorm": L, "gated_rmsnorm_bwd": L,
                      "rmsnorm": 1, "rmsnorm_bwd": 1, "add_rmsnorm": L,
                      "add_rmsnorm_bwd": L}
    want_loss, want = _qwen_smoke_grads(params, cfg.replace(use_kernels=False),
                                        batch)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
    ops.reset_launches()
    with torch.no_grad():
        assert torch.isfinite(api.loss(params, cfg, batch))
    assert ops.ssd_chunk_bwd.launches == ops.gated_rmsnorm_bwd.launches == 0


@pytest.mark.cuda
def test_wrappers_without_a_backward_refuse_on_the_card(cuda):
    """MGMark's kernels have no backward: with an input that requires
    grad they raise instead of cutting the graph."""
    x = _rand((64,), 5, torch.float32, cuda).requires_grad_(True)
    for call in (lambda: ops.stencil2d(x.reshape(8, 8),
                                       torch.ones(3, 3, device=cuda)),
                 lambda: ops.bitonic_stage(x, 1, 2),
                 lambda: ops.bitonic_block(x, 2)):
        with pytest.raises(ops.KernelBackwardMissing, match="no backward"):
            call()


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,per_layer", [
    ("qwen2-1.5b-smoke", {"rmsnorm": (0, 1), "add_rmsnorm": (2, 0)}),
    ("mamba2-1.3b-smoke", {"rmsnorm": (0, 1), "add_rmsnorm": (1, 0),
                           "gated_rmsnorm": (1, 0)})])
def test_decode_step_fuses_the_prologues(cuda, arch, per_layer):
    """One f32 decode step on the kernel path launches the fused norms
    (per_layer: (launches per layer, launches per step)) and nothing else
    of ops, and its logits match the plain path's within 1e-4."""
    from repro_torch.models import api, get_config
    cfg = get_config(arch).replace(dtype="float32")
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    outs = []
    for c in (cfg, cfg.replace(use_kernels=False)):
        cache = api.init_cache(c, 2, 32, device=cuda)
        _, cache = api.prefill(params, c, cache, {"tokens": toks})
        before = ops.launch_counts()
        logits, _ = api.decode_step(params, c, cache, toks[:, -1])
        torch.cuda.synchronize()
        after = ops.launch_counts()
        outs.append((logits, {k: after[k] - before[k] for k in after
                              if after[k] != before[k]}))
    (got, launched), (want, plain) = outs
    assert plain == {}
    assert launched == {k: a * cfg.num_layers + b
                        for k, (a, b) in per_layer.items()}
    _assert_close(got, want, dict(atol=1e-4, rtol=1e-4))


# ---------------------------------------------------------------------------
# backward kernels (flash attention, rmsnorm and its residual form)
# ---------------------------------------------------------------------------

BWD_F32 = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", [
    (2, 1024, 1024, 12, 2, 128, True),           # qwen2-1.5b's training shape
    (1, 995, 995, 12, 2, 128, True), (1, 1, 1, 12, 2, 128, True),
    (2, 100, 100, 4, 2, 16, True), (2, 65, 65, 4, 4, 32, True),
    (1, 77, 77, 6, 1, 64, True), (2, 50, 130, 4, 2, 128, False),
    (1, 130, 33, 6, 3, 32, False),
    # G = 1, 3, 8 and every head width (the bf16 dK/dV launch's cluster
    # is the largest divisor of G up to 8: G = 12 loops over 2 heads a
    # block, G = 11 over all 11 in one block)
    (1, 200, 200, 3, 3, 16, True), (2, 129, 129, 3, 1, 32, True),
    (1, 150, 150, 8, 1, 64, True), (1, 257, 257, 16, 2, 128, True),
    (1, 300, 300, 12, 1, 32, True), (1, 70, 70, 11, 1, 64, True),
    (2, 64, 100, 8, 1, 16, False)])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, B, Sq, Skv, H, K, hd,
                                        causal):
    """The forward's LSE and the backward kernel against the plain
    versions, on the same inputs (the kernel forward's o and lse)."""
    dt = getattr(torch, dtype)
    q = _rand((B, Sq, H, hd), 60, dt, cuda)
    k, v = _rand((B, Skv, K, hd), 61, dt, cuda), _rand((B, Skv, K, hd), 62,
                                                       dt, cuda)
    do = _rand((B, Sq, H, hd), 63, dt, cuda)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
    _assert_close(lse, ref.flash_attention_lse_ref(q, k, v, causal),
                  dict(atol=1e-4, rtol=1e-4))
    n = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == n + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dt and g.shape == x.shape and g.is_contiguous()
        _assert_close(g, w, BWD_F32 if dtype == "float32" else BF16)


@pytest.mark.cuda
def test_flash_bwd_kernel_takes_strided_heads(cuda):
    """q/k/v as views of one fused projection and a non-contiguous dO."""
    B, S, H, K, hd = 2, 70, 4, 2, 64
    fused = _rand((B, S, (H + 2 * K) * hd), 64, torch.float32, cuda)
    q, k, v = fused.split([H * hd, K * hd, K * hd], dim=-1)
    q, k, v = (q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd))
    do = _rand((B, H, S, hd), 65, torch.float32, cuda).transpose(1, 2)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, ref.flash_attention_bwd_ref(q, k, v, o, lse, do)):
        _assert_close(g, w, BWD_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_is_deterministic(cuda, dtype):
    """No atomics: two runs at qwen2-1.5b's training shape give the same
    bits (the bf16 dK/dV sum over a cluster's blocks in rank order)."""
    B, S, H, K, hd = 2, 1024, 12, 2, 128
    dt = getattr(torch, dtype)
    q = _rand((B, S, H, hd), 80, dt, cuda)
    k, v = _rand((B, S, K, hd), 81, dt, cuda), _rand((B, S, K, hd), 82, dt,
                                                     cuda)
    do = _rand((B, S, H, hd), 83, dt, cuda)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    a = ops.flash_attention_bwd(q, k, v, o, lse, do)
    b = ops.flash_attention_bwd(q, k, v, o, lse, do)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_bwd_bf16_kernel_takes_strided_heads_and_refuses_misaligned(
        cuda):
    """bf16 q/k/v as views of one fused projection go through TMA in
    place; a view 8 bytes off TMA's grid raises instead of being copied."""
    B, S, H, K, hd = 2, 70, 4, 2, 64
    fused = _rand((B, S, (H + 2 * K) * hd), 84, torch.bfloat16, cuda)
    q, k, v = fused.split([H * hd, K * hd, K * hd], dim=-1)
    q, k, v = (q.view(B, S, H, hd), k.view(B, S, K, hd), v.view(B, S, K, hd))
    do = _rand((B, H, S, hd), 85, torch.bfloat16, cuda).transpose(1, 2)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, ref.flash_attention_bwd_ref(q, k, v, o, lse, do)):
        _assert_close(g, w, BF16)
    wide = _rand((B, S, H * hd + 4), 86, torch.bfloat16, cuda)
    q_off = wide[..., 4:].reshape(B, S, H, hd)       # 8 bytes in
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention_bwd(q_off, k, v, o, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(2048, 1536), (1, 1536), (995, 2048),
                                    (3, 100), (4, 8960), (300, 64),
                                    (2047, 1536), (1, 2048), (2047, 2048)])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, rows, d, residual):
    dt = getattr(torch, dtype)
    x = _rand((rows, d), 66, dt, cuda)
    w = (1 + 0.1 * _rand((d,), 67, torch.float32, cuda)).to(dt)
    dy = _rand((rows, d), 68, dt, cuda)
    tol = BWD_F32 if dtype == "float32" else BF16
    if residual:
        dh = _rand((rows, d), 69, dt, cuda)
        n = ops.add_rmsnorm_bwd.launches
        got = ops.add_rmsnorm_bwd(x, w, dy, dh)
        want = ref.add_rmsnorm_bwd_ref(x, w, dy, dh)
        assert ops.add_rmsnorm_bwd.launches == n + 1
    else:
        n = ops.rmsnorm_bwd.launches
        got = ops.rmsnorm_bwd(x, w, dy)
        want = ref.rmsnorm_bwd_ref(x, w, dy)
        assert ops.rmsnorm_bwd.launches == n + 1
    torch.cuda.synchronize()
    assert got[0].dtype == dt and got[1].dtype == dt
    _assert_close(got[0], want[0], tol)
    # dw is a sum over the rows: atol relative to its largest element
    scale = float(want[1].float().abs().max())
    _assert_close(got[1], want[1], dict(atol=tol["atol"] * max(1.0, scale),
                                        rtol=tol["rtol"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_bwd_kernel_takes_unaligned_views(cuda, dtype, residual):
    """Contiguous operands that start one element past a 16-byte boundary
    take the scalar path."""
    rows, d = 37, 1536
    dt = getattr(torch, dtype)

    def off_grid(seed):
        buf = _rand((rows * d + 1,), seed, dt, cuda)
        return buf[1:].view(rows, d)
    x, dy = off_grid(90), off_grid(91)
    w = (1 + 0.1 * _rand((d,), 92, torch.float32, cuda)).to(dt)
    tol = BWD_F32 if dtype == "float32" else BF16
    if residual:
        dh = off_grid(93)
        got = ops.add_rmsnorm_bwd(x, w, dy, dh)
        want = ref.add_rmsnorm_bwd_ref(x, w, dy, dh)
    else:
        got = ops.rmsnorm_bwd(x, w, dy)
        want = ref.rmsnorm_bwd_ref(x, w, dy)
    torch.cuda.synchronize()
    _assert_close(got[0], want[0], tol)
    scale = float(want[1].float().abs().max())
    _assert_close(got[1], want[1], dict(atol=tol["atol"] * max(1.0, scale),
                                        rtol=tol["rtol"]))


@pytest.mark.cuda
def test_rmsnorm_bwd_kernel_is_deterministic(cuda):
    x = _rand((2048, 1536), 70, torch.bfloat16, cuda)
    w = _rand((1536,), 71, torch.bfloat16, cuda)
    dy = _rand((2048, 1536), 72, torch.bfloat16, cuda)
    a, b = ops.rmsnorm_bwd(x, w, dy), ops.rmsnorm_bwd(x, w, dy)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _qwen_smoke_grads(params, cfg, batch):
    flat = _leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        loss = api_loss(params, cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, flat)
    finally:
        for t in flat:
            t.requires_grad_(False)


def api_loss(params, cfg, batch):
    from repro_torch.models import api
    return api.loss(params, cfg, batch)


@pytest.mark.cuda
def test_qwen_grads_through_the_kernels_match_plain(cuda):
    """qwen2-1.5b-smoke in f32 with attn_impl="flash" (the smoke config
    selects "ref", which would never reach flash): every leaf's gradient
    through the kernels' backward matches the plain path's, and each
    backward kernel ran once per forward call."""
    from repro_torch.models import api, get_config
    cfg = get_config("qwen2-1.5b-smoke").replace(attn_impl="flash")
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(3))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    ops.reset_launches()
    loss, got = _qwen_smoke_grads(params, cfg, batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    L = cfg.num_layers
    assert counts == {"flash_attention": L, "flash_attention_bwd": L,
                      "rmsnorm": 1, "rmsnorm_bwd": 1, "add_rmsnorm": 2 * L,
                      "add_rmsnorm_bwd": 2 * L}
    want_loss, want = _qwen_smoke_grads(params, cfg.replace(use_kernels=False),
                                        batch)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


@pytest.mark.cuda
def test_serving_under_no_grad_stores_no_lse_and_launches_no_backward(
        cuda, monkeypatch):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api, get_config
    flags = []
    real = fa.flash_attention

    def spy(*args, **kwargs):
        flags.append(kwargs.get("with_lse", False))
        return real(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_attention", spy)
    cfg = get_config("qwen2-1.5b-smoke").replace(attn_impl="flash",
                                                 dtype="bfloat16")
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(4))
    ops.reset_launches()
    with torch.no_grad():
        cache = api.init_cache(cfg, 2, 48, device=cuda)
        _, cache = api.prefill(params, cfg, cache, {"tokens": toks})
        api.decode_step(params, cfg, cache, toks[:, -1])
    # and params that require grad, under no_grad, as an engine would hold
    for t in _leaves(params):
        t.requires_grad_(True)
    with torch.no_grad():
        api.forward(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.num_layers
    assert flags == [False] * (2 * cfg.num_layers)
    assert counts["flash_attention_bwd"] == counts["rmsnorm_bwd"] == \
        counts["add_rmsnorm_bwd"] == 0


@pytest.mark.cuda
def test_plain_backward_is_never_reached_on_the_card(cuda, monkeypatch):
    """The plain versions, forward and backward, patched to raise: a
    kernel-path backward on the card never calls them."""
    from repro_torch.models import api, get_config

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")
    for name in ("flash_attention_ref", "flash_attention_lse_ref",
                 "flash_attention_bwd_ref", "rmsnorm_ref", "add_rmsnorm_ref",
                 "rmsnorm_bwd_ref", "add_rmsnorm_bwd_ref", "gated_rmsnorm_ref",
                 "gated_rmsnorm_bwd_ref", "ssd_chunk_ref",
                 "ssd_chunk_bwd_ref"):
        monkeypatch.setattr(ref, name, refuse)
    for arch, dtype in (("qwen2-1.5b-smoke", "float32"),
                        ("qwen2-1.5b-smoke", "bfloat16"),
                        ("mamba2-1.3b-smoke", "float32"),
                        ("mamba2-1.3b-smoke", "bfloat16")):
        cfg = get_config(arch).replace(attn_impl="flash", dtype=dtype)
        params = api.init(0, cfg, device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 33), device=cuda,
                             generator=torch.Generator(cuda).manual_seed(5))
        _, grads = _qwen_smoke_grads(
            params, cfg, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
        assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# the fault-tolerant loop, checkpoints and the cost front end on the card
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_card_state_is_bit_exact(cuda, tmp_path):
    """A bf16 TrainState on the card (qwen2-1.5b at full width, 4 layers,
    after one step) saved asynchronously and restored to the card: every
    leaf bit for bit, the step an int."""
    from repro_torch.models import api, get_config
    from repro_torch.sharding import umode
    from repro_torch.train import optim
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = get_config("qwen2-1.5b").replace(num_layers=4)
    state = optim.init_state(api.init(0, cfg, device=cuda))
    toks = torch.randint(0, cfg.vocab_size, (1, 257), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(6))
    state, _ = umode.make_train_step(cfg)(
        state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    mgr = CheckpointManager(str(tmp_path), keep=1, async_save=True)
    mgr.save(1, state)
    mgr.wait()
    got, manifest = mgr.restore(device=cuda)
    assert got["step"] == 1 and manifest["step"] == 1
    tensors = (lambda st: optim.leaves({k: st[k] for k in
                                        ("params", "mu", "nu")}))
    want, flat = tensors(state), tensors(got)
    assert len(flat) == len(want) == 3 * len(optim.leaves(state["params"]))
    assert {t.dtype for t in optim.leaves(got["params"])} == {torch.bfloat16}
    for a, b in zip(flat, want):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_train_step_trace_counts_equal_the_launch_counters(cuda):
    """One full-width qwen2-1.5b training step on the card, and the same
    step traced on meta: the kernel trace ops equal the launch counts."""
    from repro_torch.core import hlo
    from repro_torch.models import api, get_config
    from repro_torch.sharding import umode
    from repro_torch.train import optim
    cfg = get_config("qwen2-1.5b")
    step = umode.make_train_step(cfg)
    state = optim.init_state(api.init(0, cfg, device=cuda))
    toks = torch.randint(0, cfg.vocab_size, (1, 257), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(7))
    ops.reset_launches()
    state, m = step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    assert np.isfinite(float(m["loss"]))
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    del state
    meta = optim.init_state(api.init(0, cfg, device="meta"))
    batch = {k: torch.zeros((1, 256), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    cost = hlo.analyze(step, meta, batch)
    traced = {k: v for k, v in hlo.count_ops(cost).items()
              if not k.startswith("aten.")}
    assert traced == launched
    assert launched["flash_attention_bwd"] == cfg.num_layers


@pytest.mark.cuda
def test_loop_on_the_card_replays_through_the_kernels(cuda, tmp_path):
    """qwen2-1.5b-smoke (f32, flash) through the loop on the card with a
    fault at step 3 and a checkpoint every 2: one restart, the first
    replayed loss bit-identical to its first run, every kernel and
    backward kernel launched."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import LoopConfig, run
    cfg = get_config("qwen2-1.5b-smoke").replace(attn_impl="flash")
    ops.reset_launches()
    rep = run(cfg, make_mesh((1, 1), ("data", "model")),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=2),
              loop_cfg=LoopConfig(total_steps=5, ckpt_every=2,
                                  ckpt_dir=str(tmp_path), async_ckpt=True),
              fault_schedule={3: RuntimeError("injected")}, verbose=False)
    assert (rep.restarts, rep.final_step, rep.steps_run) == (1, 5, 6)
    assert rep.losses[3] == rep.losses[2]          # step 2, replayed
    counts = ops.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd", "add_rmsnorm", "add_rmsnorm_bwd"):
        assert counts[name] > 0, name


@pytest.mark.cuda
def test_mamba_loop_on_the_card_trains_and_replays(cuda, tmp_path):
    """mamba2-1.3b-smoke through the loop on the card with a fault at
    step 3 and a checkpoint every 2: one restart, the replayed loss
    bit-identical to its first run, the SSD and gated-norm backward
    kernels launched once a layer of every step run."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_config
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import LoopConfig, run
    cfg = get_config("mamba2-1.3b-smoke")
    ops.reset_launches()
    rep = run(cfg, make_mesh((1, 1), ("data", "model")),
              DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=2),
              loop_cfg=LoopConfig(total_steps=5, ckpt_every=2,
                                  ckpt_dir=str(tmp_path), async_ckpt=True),
              fault_schedule={3: RuntimeError("injected")}, verbose=False)
    assert (rep.restarts, rep.final_step, rep.steps_run) == (1, 5, 6)
    assert rep.losses[3] == rep.losses[2]          # step 2, replayed
    assert np.isfinite(rep.losses).all()
    counts = ops.launch_counts()
    for name in ("ssd_chunk_kernel", "ssd_chunk_bwd", "gated_rmsnorm",
                 "gated_rmsnorm_bwd"):
        assert counts[name] == rep.steps_run * cfg.num_layers, name


# the hybrid and MoE smokes, with attn_impl="flash" where their head dim
# is a flash shape (zamba2's 16, so flash and SSD run in one model;
# qwen3-moe's 16; dbrx's 8 is none, so it keeps "ref"): a forward's
# kernel launches
HYBRID_MOE_SMOKES = {
    "zamba2-7b-smoke": ("flash", lambda L, G: {
        "flash_attention": G, "ssd_chunk_kernel": L, "gated_rmsnorm": L,
        "rmsnorm": 1, "add_rmsnorm": L + 2 * G}),
    "qwen3-moe-30b-a3b-smoke": ("flash", lambda L, G: {
        "flash_attention": L, "rmsnorm": 1, "add_rmsnorm": 2 * L}),
    "dbrx-132b-smoke": ("ref", lambda L, G: {
        "rmsnorm": 1, "add_rmsnorm": 2 * L})}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(HYBRID_MOE_SMOKES))
def test_hybrid_and_moe_prefill_and_decode_match_plain(cuda, arch):
    """A 37-token prefill (ragged for the SSD's chunk of 8 and for the
    MoE's 4 groups) and 4 decode steps, f32, on the kernel path against
    the plain path: logits and every cache leaf; the forward launched
    each kernel of the path as many times as its layers say."""
    from repro_torch.models import api, get_config
    impl, launches = HYBRID_MOE_SMOKES[arch]
    cfg = get_config(arch).replace(attn_impl=impl)
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 37), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(5))
    L = cfg.num_layers
    G = L // cfg.attn_every if cfg.attn_every else 0
    outs = []
    for c in (cfg, cfg.replace(use_kernels=False)):
        ops.reset_launches()
        api.forward(params, c, {"tokens": toks})
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == (launches(L, G) if c is cfg else {})
        cache = api.init_cache(c, 2, 48, device=cuda)
        logits, cache = api.prefill(params, c, cache, {"tokens": toks})
        steps = [logits]
        for i in range(4):              # the same tokens on both paths
            logits, cache = api.decode_step(params, c, cache, toks[:, i])
            steps.append(logits)
        outs.append((steps, cache))
    (got, got_c), (want, want_c) = outs
    for g, w in zip(got, want):
        _assert_close(g, w, dict(atol=1e-4, rtol=1e-4))
    for key in want_c:
        _assert_close(got_c[key], want_c[key], dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(HYBRID_MOE_SMOKES))
def test_hybrid_and_moe_grads_through_the_kernels_match_plain(cuda, arch):
    """f32 gradients of the loss (batch 2 x 64) through the kernels'
    backward against the plain path's, each leaf within 1e-4 of its max
    |g|; each backward kernel once per forward call."""
    from repro_torch.models import api, get_config
    impl, launches = HYBRID_MOE_SMOKES[arch]
    cfg = get_config(arch).replace(attn_impl=impl)
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(6))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    L = cfg.num_layers
    G = L // cfg.attn_every if cfg.attn_every else 0
    ops.reset_launches()
    loss, got = _qwen_smoke_grads(params, cfg, batch)
    torch.cuda.synchronize()
    fwd = launches(L, G)
    want_counts = {**fwd, **{k.replace("_kernel", "") + "_bwd": v
                             for k, v in fwd.items()}}
    assert {k: v for k, v in ops.launch_counts().items() if v} == \
        want_counts
    want_loss, want = _qwen_smoke_grads(params, cfg.replace(use_kernels=False),
                                        batch)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


# the enc-dec and VLM families' attention shapes at full width: whisper-
# base's encoder (non-causal 1500 x 1500, MHA, hd 64), its cross-attention
# at a decoder prefill (8 x 1500) and at decode (1 x 1500), llava-next-
# 34b's causal prefill (2880 patches + 64 tokens, GQA 56:8, hd 128)
MODAL_FLASH_SHAPES = [(4, 1500, 1500, 8, 8, 64, False),
                      (4, 8, 1500, 8, 8, 64, False),
                      (4, 1, 1500, 8, 8, 64, False),
                      (1, 2944, 2944, 56, 8, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal", MODAL_FLASH_SHAPES)
def test_flash_kernel_matches_plain_at_encdec_and_vlm_shapes(
        cuda, dtype, B, Sq, Skv, H, K, hd, causal):
    """One q row or eight against 1500 keys: a 64-row bf16 tile holds
    them and masks the rest, the q box runs past Sq, the log-sum-exp is
    written for the live rows only."""
    dt = getattr(torch, dtype)
    q = _rand((B, Sq, H, hd), 90, dt, cuda)
    k, v = _rand((B, Skv, K, hd), 91, dt, cuda), _rand((B, Skv, K, hd), 92,
                                                       dt, cuda)
    from repro_torch.kernels import flash_attention as fa
    got, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    _assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal),
                  F32 if dtype == "float32" else BF16)
    _assert_close(lse, ref.flash_attention_lse_ref(q, k, v, causal),
                  dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv", [(8, 1500, 1500), (8, 448, 1500)])
def test_flash_bwd_kernel_matches_plain_at_whisper_shapes(cuda, dtype, B, Sq,
                                                          Skv):
    """whisper-base's training batch of 8 x 448 tokens: the encoder's
    non-causal 1500 x 1500 and the cross-attention's 448 x 1500, where
    the dK/dV launch walks every q tile of the padded scratch (MHA: a
    cluster of one)."""
    dt = getattr(torch, dtype)
    H, hd = 8, 64
    q = _rand((B, Sq, H, hd), 93, dt, cuda)
    k, v = _rand((B, Skv, H, hd), 94, dt, cuda), _rand((B, Skv, H, hd), 95,
                                                       dt, cuda)
    do = _rand((B, Sq, H, hd), 96, dt, cuda)
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa.flash_attention(q, k, v, causal=False, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, False)
    for g, w in zip(got, want):
        _assert_close(g, w, BWD_F32 if dtype == "float32" else BF16)


# the enc-dec and VLM smokes: whisper's on flash (hd 16), llava's on
# "ref" (hd 8 is no flash shape); a forward's kernel launches
MODAL_SMOKES = {
    "whisper-base-smoke": ("flash", lambda c: {
        "flash_attention": c.encoder_layers + 2 * c.num_layers,
        "rmsnorm": 2,
        "add_rmsnorm": 2 * c.encoder_layers + 3 * c.num_layers}),
    "llava-next-34b-smoke": ("ref", lambda c: {
        "rmsnorm": 1, "add_rmsnorm": 2 * c.num_layers})}


def _modal(cfg, B, cuda, seed):
    """The family's modality stub for a batch of B, from ``seed``."""
    key, n = (("frames", cfg.encoder_seq) if cfg.family == "encdec"
              else ("patches", cfg.num_patches))
    return {key: _rand((B, n, cfg.d_model), seed, torch.float32, cuda)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(MODAL_SMOKES))
def test_encdec_and_vlm_prefill_and_decode_match_plain(cuda, arch):
    """A 13-token prefill and 4 decode steps, f32, on the kernel path
    against the plain path: logits and every cache leaf (the enc-dec's
    cross k/v included); the forward launched each kernel of the path as
    many times as its layers say."""
    from repro_torch.models import api, get_config
    impl, launches = MODAL_SMOKES[arch]
    cfg = get_config(arch).replace(attn_impl=impl)
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 13), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(7))
    batch = {"tokens": toks, **_modal(cfg, 2, cuda, 97)}
    outs = []
    for c in (cfg, cfg.replace(use_kernels=False)):
        ops.reset_launches()
        api.forward(params, c, batch)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == (launches(c) if c is cfg else {})
        cache = api.init_cache(c, 2, 48, device=cuda)
        logits, cache = api.prefill(params, c, cache, batch)
        steps = [logits]
        for i in range(4):              # the same tokens on both paths
            logits, cache = api.decode_step(params, c, cache, toks[:, i])
            steps.append(logits)
        outs.append((steps, cache))
    (got, got_c), (want, want_c) = outs
    for g, w in zip(got, want):
        _assert_close(g, w, dict(atol=1e-4, rtol=1e-4))
    for key in want_c:
        _assert_close(got_c[key], want_c[key], dict(atol=1e-4, rtol=1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(MODAL_SMOKES))
def test_encdec_and_vlm_grads_through_the_kernels_match_plain(cuda, arch):
    """f32 gradients of the loss (batch 2 x 64 tokens and the stub)
    through the kernels' backward against the plain path's, each leaf
    within 1e-4 of its max |g|; each backward kernel once per forward
    call (whisper's flash backward in every encoder, self- and
    cross-attention block)."""
    from repro_torch.models import api, get_config
    impl, launches = MODAL_SMOKES[arch]
    cfg = get_config(arch).replace(attn_impl=impl)
    params = api.init(0, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(8))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             **_modal(cfg, 2, cuda, 98)}
    ops.reset_launches()
    loss, got = _qwen_smoke_grads(params, cfg, batch)
    torch.cuda.synchronize()
    fwd = launches(cfg)
    assert {k: v for k, v in ops.launch_counts().items() if v} == \
        {**fwd, **{k + "_bwd": v for k, v in fwd.items()}}
    want_loss, want = _qwen_smoke_grads(params, cfg.replace(use_kernels=False),
                                        batch)
    assert abs(float(loss) - float(want_loss)) < 1e-4
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err
