"""Gradients in repro_torch (CPU): the model's against the JAX package's,
the plain backward versions of the kernels (``kernels/ref.py``) against
autograd of the plain forwards, and the autograd Functions that carry the
kernels' backward on the card, with their launchers stood in for by the
plain versions.

Tolerances: model gradients per leaf within 1e-4 of the leaf's max |g|
(f32, sums in another order in the two frameworks); the plain backward
against autograd in f32 atol 1e-5 / rtol 1e-4 (the same function, other
f32 sums), and in f64 through ``torch.autograd.gradcheck`` (its own
defaults: eps 1e-6, atol 1e-5, rtol 1e-3 against finite differences);
the log-sum-exp in f64 atol 1e-12."""
import copy
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402
from repro_torch.train import optim  # noqa: E402

from _torch_parity import (assert_leaves_close, loss_and_grads as _grads,  # noqa: E402
                           shared_params)

ARCH = "qwen2-1.5b-smoke"
F32 = dict(atol=1e-5, rtol=1e-4)
LEAF_TOL = 1e-4


def _rand(shape, seed, dtype=torch.float32, requires_grad=False):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(x, dtype=dtype, requires_grad=requires_grad)




def _batch(seed, B=2, S=19, mask=False):
    toks = np.random.default_rng(seed).integers(
        0, get_config(ARCH).vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if mask:
        batch["mask"] = (np.arange(S) < S - 4).astype(np.float32)[None] \
            .repeat(B, 0)
    return batch


# ---------------------------------------------------------------------------
# the model's gradients against jax.grad of the reference loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl,mask", [("ref", False), ("flash", False),
                                            ("flash", True)])
def test_loss_grads_match_jax(attn_impl, mask):
    jp, tp = shared_params(ARCH)
    batch = _batch(11, mask=mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.value_and_grad(
        lambda p: japi.loss(p, jget_config(ARCH), jb))(jp)
    loss, got = _grads(tp, get_config(ARCH).replace(attn_impl=attn_impl),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(want_loss)) < 1e-5
    assert_leaves_close(got, want, LEAF_TOL)


# ---------------------------------------------------------------------------
# the plain backward versions
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, S, H, K, hd, causal: G = H / K in {1, 2, 6}
    (1, 1, 2, 2, 16, True), (2, 37, 4, 2, 16, True), (1, 29, 6, 1, 32, True),
    (2, 64, 12, 2, 64, True), (1, 23, 4, 4, 128, True),
    (2, 17, 6, 3, 32, False)]


def _flash_inputs(B, S, H, K, hd, dtype, seed=0, Skv=None):
    Skv = S if Skv is None else Skv
    return (_rand((B, S, H, hd), seed, dtype, True),
            _rand((B, Skv, K, hd), seed + 1, dtype, True),
            _rand((B, Skv, K, hd), seed + 2, dtype, True))


@pytest.mark.parametrize("B,S,H,K,hd,causal", FLASH_CASES)
def test_flash_bwd_ref_matches_autograd(B, S, H, K, hd, causal):
    q, k, v = _flash_inputs(B, S, H, K, hd, torch.float32)
    o = ref.flash_attention_ref(q, k, v, causal)
    do = _rand(o.shape, 9)
    want = torch.autograd.grad(o, (q, k, v), do)
    lse = ref.flash_attention_lse_ref(q, k, v, causal)
    got = ref.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                      o.detach(), lse, do, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **F32)


def test_flash_bwd_ref_rounds_to_the_inputs_dtype():
    q, k, v = (t.detach() for t in _flash_inputs(1, 9, 4, 2, 16,
                                                 torch.bfloat16))
    o = ref.flash_attention_ref(q, k, v)
    got = ref.flash_attention_bwd_ref(q, k, v, o,
                                      ref.flash_attention_lse_ref(q, k, v),
                                      _rand(o.shape, 3, torch.bfloat16))
    assert all(g.dtype == torch.bfloat16 for g in got)
    with pytest.raises(ValueError, match="Sq == Skv"):
        ref.flash_attention_lse_ref(q, k[:, :5], v[:, :5])


class _PlainFlash(torch.autograd.Function):
    """flash_attention_ref with flash_attention_bwd_ref as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = ref.flash_attention_ref(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o,
                              ref.flash_attention_lse_ref(q, k, v, causal))
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        return (*ref.flash_attention_bwd_ref(*ctx.saved_tensors, do,
                                             ctx.causal), None)


@pytest.mark.parametrize("B,S,H,K,hd,causal,fast", [
    (1, 3, 2, 2, 16, True, False), (1, 4, 2, 1, 16, True, False),
    (1, 3, 6, 1, 16, True, False), (2, 5, 4, 2, 32, True, True),
    (1, 3, 6, 3, 64, True, True), (1, 4, 2, 2, 128, True, True),
    (1, 3, 4, 2, 16, False, False)])
def test_flash_bwd_ref_passes_gradcheck_f64(B, S, H, K, hd, causal, fast):
    q, k, v = _flash_inputs(B, S, H, K, hd, torch.float64, seed=3)
    assert torch.autograd.gradcheck(
        lambda *t: _PlainFlash.apply(*t, causal), (q, k, v), fast_mode=fast)


@pytest.mark.parametrize("B,S,H,K,hd,causal", FLASH_CASES)
def test_flash_lse_ref_matches_logsumexp(B, S, H, K, hd, causal):
    q, k, v = (t.detach() for t in _flash_inputs(B, S, H, K, hd,
                                                 torch.float64))
    want = torch.empty(B, H, S, dtype=torch.float64)
    for b in range(B):
        for h in range(H):
            s = q[b, :, h] @ k[b, :, h // (H // K)].T / math.sqrt(hd)
            if causal:
                s = s.masked_fill(torch.ones(S, S, dtype=torch.bool)
                                  .triu(1), -math.inf)
            want[b, h] = torch.logsumexp(s, dim=-1)
    got = ref.flash_attention_lse_ref(q, k, v, causal)
    assert got.shape == (B, H, S)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("rows,d", [(1, 16), (7, 64), (3, 1536)])
def test_rmsnorm_bwd_refs_match_autograd(rows, d):
    x, r = _rand((rows, d), 1, requires_grad=True), _rand((rows, d), 2,
                                                          requires_grad=True)
    w = (1 + 0.3 * _rand((d,), 3)).requires_grad_(True)
    dy, dh = _rand((rows, d), 4), _rand((rows, d), 5)
    out = ref.rmsnorm_ref(x, w)
    torch.testing.assert_close(
        ref.rmsnorm_bwd_ref(x.detach(), w.detach(), dy),
        torch.autograd.grad(out, (x, w), dy), **F32)
    h, out = ref.add_rmsnorm_ref(x, r, w)
    gx, gr, gw = torch.autograd.grad((h, out), (x, r, w), (dh, dy))
    got_x, got_w = ref.add_rmsnorm_bwd_ref(h.detach(), w.detach(), dy, dh)
    torch.testing.assert_close((got_x, got_x, got_w), (gx, gr, gw), **F32)
    # dh None: only the norm's gradient
    torch.testing.assert_close(
        ref.add_rmsnorm_bwd_ref(h.detach(), w.detach(), dy),
        ref.rmsnorm_bwd_ref(h.detach(), w.detach(), dy), atol=0, rtol=0)


class _PlainAddNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, w):
        h, out = ref.add_rmsnorm_ref(x, r, w)
        ctx.save_for_backward(h, w)
        return h, out

    @staticmethod
    def backward(ctx, dh, dout):
        dx, dw = ref.add_rmsnorm_bwd_ref(*ctx.saved_tensors, dout, dh)
        return dx, dx, dw


def test_rmsnorm_bwd_refs_pass_gradcheck_f64():
    x = _rand((3, 8), 6, torch.float64, True)
    r = _rand((3, 8), 7, torch.float64, True)
    w = (1 + 0.3 * _rand((8,), 8, torch.float64)).requires_grad_(True)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return ref.rmsnorm_ref(x, w)

        @staticmethod
        def backward(ctx, dy):
            return ref.rmsnorm_bwd_ref(*ctx.saved_tensors, dy)
    assert torch.autograd.gradcheck(Plain.apply, (x, w))
    assert torch.autograd.gradcheck(_PlainAddNorm.apply, (x, r, w))


# the SSD chunk: R, H, Q, P, N, a head stride of 0 for B and C (as
# ops.ssd_chunked passes them); Q in {1, 7, 64}, N != P
SSD_CASES = [(2, 3, 1, 4, 6, False), (2, 3, 7, 5, 3, False),
             (1, 2, 64, 16, 8, False), (2, 4, 7, 8, 16, True),
             (1, 3, 64, 8, 16, True)]


def _ssd_inputs(R, H, Q, P, N, shared, dtype=torch.float32, seed=0):
    """x, dt (softplus), cs (cumsum of dt * A, A < 0), Bm, Cm, each
    requiring grad; B and C (R,H,Q,N) views of (R,1,Q,N) when shared."""
    rng = np.random.default_rng(seed)
    t = (lambda a: torch.tensor(a, dtype=dtype))
    x = t(rng.standard_normal((R, H, Q, P)))
    dt = torch.nn.functional.softplus(t(rng.standard_normal((R, H, Q))))
    A = -t(np.exp(rng.standard_normal(H)))
    cs = torch.cumsum(dt * A[None, :, None], dim=-1)
    G = 1 if shared else H
    Bm = t(rng.standard_normal((R, G, Q, N)))
    Cm = t(rng.standard_normal((R, G, Q, N)))
    leaves = [a.requires_grad_(True) for a in (x, dt, cs, Bm, Cm)]
    if shared:
        return leaves, (x, dt, cs, Bm.expand(R, H, Q, N),
                        Cm.expand(R, H, Q, N))
    return leaves, tuple(leaves)


def _ssd_bwd_summed(args, dy, dS, shared):
    """ref.ssd_chunk_bwd_ref, dB and dC summed over the heads where B and
    C are shared (what autograd of the expand does)."""
    dx, ddt, dcs, dB, dC = ref.ssd_chunk_bwd_ref(
        *(a.detach() for a in args), dy, dS)
    if shared:
        dB, dC = dB.sum(1, keepdim=True), dC.sum(1, keepdim=True)
    return dx, ddt, dcs, dB, dC


@pytest.mark.parametrize("R,H,Q,P,N,shared", SSD_CASES)
def test_ssd_bwd_ref_matches_autograd(R, H, Q, P, N, shared):
    leaves, args = _ssd_inputs(R, H, Q, P, N, shared)
    y, s = ref.ssd_chunk_ref(*args)
    dy, dS = _rand(y.shape, 7), _rand(s.shape, 8)
    want = torch.autograd.grad((y, s), leaves, (dy, dS))
    got = _ssd_bwd_summed(args, dy, dS, shared)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, **F32)


class _PlainSSD(torch.autograd.Function):
    """ssd_chunk_ref with ssd_chunk_bwd_ref as its backward."""

    @staticmethod
    def forward(ctx, x, dt, cs, Bm, Cm):
        ctx.save_for_backward(x, dt, cs, Bm, Cm)
        return ref.ssd_chunk_ref(x, dt, cs, Bm, Cm)

    @staticmethod
    def backward(ctx, dy, dS):
        return ref.ssd_chunk_bwd_ref(*ctx.saved_tensors, dy, dS)


@pytest.mark.parametrize("R,H,Q,P,N,shared", [
    (1, 2, 1, 3, 2, False), (1, 2, 5, 3, 4, False), (2, 2, 4, 2, 3, True)])
def test_ssd_bwd_ref_passes_gradcheck_f64(R, H, Q, P, N, shared):
    leaves, _ = _ssd_inputs(R, H, Q, P, N, shared, torch.float64, seed=4)
    x, dt, cs, Bm, Cm = leaves

    def fn(x, dt, cs, Bm, Cm):
        if shared:
            Bm, Cm = Bm.expand(R, H, Q, N), Cm.expand(R, H, Q, N)
        return _PlainSSD.apply(x, dt, cs, Bm, Cm)
    assert torch.autograd.gradcheck(fn, tuple(t.detach().requires_grad_()
                                              for t in leaves))


@pytest.mark.parametrize("R,H,Q,P,N,shared", SSD_CASES)
def test_ssd_bwd_ref_matches_jax_vjp(R, H, Q, P, N, shared):
    """jax.vjp of the reference's plain SSD chunk (repro.kernels.ref), the
    function its Pallas kernel computes, on the same numpy inputs."""
    from repro.kernels import ref as jref
    leaves, args = _ssd_inputs(R, H, Q, P, N, shared)
    y, s = ref.ssd_chunk_ref(*args)
    dy, dS = _rand(y.shape, 9), _rand(s.shape, 10)
    jargs = [jnp.asarray(a.detach().numpy()) for a in args]
    _, vjp = jax.vjp(jref.ssd_chunk_ref, *jargs)
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dS.numpy())))
    got = ref.ssd_chunk_bwd_ref(*(a.detach() for a in args), dy, dS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)


def _gate_inputs(rows, d, dtype=torch.float32, seed=0):
    return (_rand((rows, d), seed, dtype, True),
            (2 * _rand((rows, d), seed + 1, dtype)).requires_grad_(True),
            (1 + 0.3 * _rand((d,), seed + 2, dtype)).requires_grad_(True))


@pytest.mark.parametrize("rows,d", [(1, 16), (7, 64), (3, 4096)])
def test_gated_rmsnorm_bwd_ref_matches_autograd(rows, d):
    x, z, w = _gate_inputs(rows, d)
    out = ref.gated_rmsnorm_ref(x, z, w)
    dy = _rand(out.shape, 4)
    want = torch.autograd.grad(out, (x, z, w), dy)
    got = ref.gated_rmsnorm_bwd_ref(x.detach(), z.detach(), w.detach(), dy)
    torch.testing.assert_close(got, want, **F32)


def test_gated_rmsnorm_bwd_ref_rounds_once_to_the_dtype():
    """bf16 inputs: each gradient comes back in bf16, within bf16's
    tolerance of autograd (which rounds at every eager op)."""
    x, z, w = _gate_inputs(4, 64, torch.bfloat16)
    out = ref.gated_rmsnorm_ref(x, z, w)
    dy = _rand(out.shape, 5, torch.bfloat16)
    want = torch.autograd.grad(out, (x, z, w), dy)
    got = ref.gated_rmsnorm_bwd_ref(x.detach(), z.detach(), w.detach(), dy)
    assert all(g.dtype == torch.bfloat16 for g in got)
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


def test_gated_rmsnorm_bwd_ref_passes_gradcheck_f64():
    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, z, w):
            ctx.save_for_backward(x, z, w)
            return ref.gated_rmsnorm_ref(x, z, w)

        @staticmethod
        def backward(ctx, dy):
            return ref.gated_rmsnorm_bwd_ref(*ctx.saved_tensors, dy)
    assert torch.autograd.gradcheck(Plain.apply,
                                    _gate_inputs(3, 8, torch.float64, 6))


@pytest.mark.parametrize("rows,d", [(5, 64), (2, 4096)])
def test_gated_rmsnorm_bwd_ref_matches_jax_vjp(rows, d):
    """jax.vjp of the reference's gated norm, rms_norm(y * silu(z), w)
    (repro/models/ssm.py), on the same numpy inputs."""
    from repro.models import layers as jlayers
    x, z, w = (t.detach() for t in _gate_inputs(rows, d, seed=11))
    dy = _rand((rows, d), 12)
    _, vjp = jax.vjp(lambda a, b, c: jlayers.rms_norm(a * jax.nn.silu(b), c),
                     *(jnp.asarray(t.numpy()) for t in (x, z, w)))
    want = vjp(jnp.asarray(dy.numpy()))
    got = ref.gated_rmsnorm_bwd_ref(x, z, w, dy)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), **F32)


# ---------------------------------------------------------------------------
# the autograd Functions of ops, their launchers stood in for by the plain
# versions (the CUDA launchers run only on the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launchers(monkeypatch):
    """ops as on the card (its device test says 'not CPU'), with each CUDA
    launcher replaced by its plain version; returns the with_lse flag of
    every forward flash launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd
    lse_flags = []

    def flash(q, k, v, causal=True, with_lse=False):
        lse_flags.append(with_lse)
        out = ref.flash_attention_ref(q, k, v, causal)
        return (out, ref.flash_attention_lse_ref(q, k, v, causal)) \
            if with_lse else out

    def norm_bwd(x, w, dy, eps=1e-6, dh=None):
        return ref.add_rmsnorm_bwd_ref(x, w, dy, dh, eps)
    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(fa, "flash_attention", flash)
    monkeypatch.setattr(fa, "flash_attention_bwd", ref.flash_attention_bwd_ref)
    monkeypatch.setattr(rms, "rmsnorm", ref.rmsnorm_ref)
    monkeypatch.setattr(rms, "add_rmsnorm", ref.add_rmsnorm_ref)
    monkeypatch.setattr(rms, "rmsnorm_bwd", norm_bwd)
    monkeypatch.setattr(rms, "gated_rmsnorm", ref.gated_rmsnorm_ref)
    monkeypatch.setattr(rms, "gated_rmsnorm_bwd", ref.gated_rmsnorm_bwd_ref)
    monkeypatch.setattr(ssd, "ssd_chunk", ref.ssd_chunk_ref)
    monkeypatch.setattr(ssd, "ssd_chunk_bwd", ref.ssd_chunk_bwd_ref)
    yield lse_flags
    ops.reset_launches()


def test_kernel_path_grads_go_through_the_functions(plain_launchers):
    """api.loss through ops' Functions: the gradients of the plain path,
    each backward wrapper called once per forward call (flash and the
    residual norms per layer, one plain norm), the LSE asked for only
    with grad."""
    _, tp = shared_params(ARCH)
    cfg = get_config(ARCH).replace(attn_impl="flash")
    batch = {k: torch.from_numpy(v) for k, v in _batch(12).items()}
    want_loss, want = _grads(tp, cfg.replace(use_kernels=False), batch)
    ops.reset_launches()
    loss, got = _grads(tp, cfg, batch)
    L = cfg.num_layers
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"flash_attention": L, "flash_attention_bwd": L,
                      "rmsnorm": 1, "rmsnorm_bwd": 1,
                      "add_rmsnorm": 2 * L, "add_rmsnorm_bwd": 2 * L}
    assert plain_launchers == [True] * L
    assert abs(float(loss) - float(want_loss)) < 1e-6
    for g, w in zip(optim.leaves(got), optim.leaves(want)):
        torch.testing.assert_close(g, w, atol=LEAF_TOL * float(w.abs().max()),
                                   rtol=0)

    ops.reset_launches()
    plain_launchers.clear()
    with torch.no_grad():
        api.loss(tp, cfg, batch)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"flash_attention": L, "rmsnorm": 1,
                      "add_rmsnorm": 2 * L}
    assert plain_launchers == [False] * L


MAMBA = "mamba2-1.3b-smoke"


@pytest.mark.parametrize("S", [19, 16])
def test_mamba_kernel_path_grads_go_through_the_functions(plain_launchers, S):
    """mamba2-1.3b-smoke's api.loss through ops' Functions (Q = 8: a
    ragged S pads the last chunk): the gradients of the plain path, the
    SSD and gated-norm backward wrappers each called once per forward
    call, once a layer; under no_grad no backward."""
    _, tp = shared_params(MAMBA)
    cfg = get_config(MAMBA)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    want_loss, want = _grads(tp, cfg.replace(use_kernels=False), batch)
    ops.reset_launches()
    loss, got = _grads(tp, cfg, batch)
    L = cfg.num_layers
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"ssd_chunk_kernel": L, "ssd_chunk_bwd": L,
                      "gated_rmsnorm": L, "gated_rmsnorm_bwd": L,
                      "rmsnorm": 1, "rmsnorm_bwd": 1, "add_rmsnorm": L,
                      "add_rmsnorm_bwd": L}
    assert abs(float(loss) - float(want_loss)) < 1e-6
    for g, w in zip(optim.leaves(got), optim.leaves(want)):
        torch.testing.assert_close(g, w, atol=LEAF_TOL * float(w.abs().max()),
                                   rtol=0)
    ops.reset_launches()
    with torch.no_grad():
        api.loss(tp, cfg, batch)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"ssd_chunk_kernel": L, "gated_rmsnorm": L,
                      "rmsnorm": 1, "add_rmsnorm": L}


def test_ssd_function_takes_an_unread_output(plain_launchers):
    """Either output of the SSD chunk may go unread: its gradient arrives
    as zeros, and the backward is the plain one with that zero."""
    leaves, args = _ssd_inputs(1, 2, 7, 4, 3, True)
    y, s = ops.ssd_chunk_kernel(*args)
    dy = _rand(y.shape, 3)
    got = torch.autograd.grad(y, leaves, dy)
    want = _ssd_bwd_summed(args, dy, torch.zeros_like(s), True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_add_rmsnorm_function_takes_a_missing_gradient(plain_launchers):
    """Either output of add_rmsnorm may be unread: its gradient arrives as
    None, and x and r get the same gradient."""
    x, r = _rand((3, 16), 1, requires_grad=True), _rand((3, 16), 2,
                                                        requires_grad=True)
    w = (1 + 0.3 * _rand((16,), 3)).requires_grad_(True)
    dy = _rand((3, 16), 4)
    h, out = ops.add_rmsnorm(x, r, w)
    gx, gr, gw = torch.autograd.grad(out, (x, r, w), dy)
    want = ref.add_rmsnorm_bwd_ref(h.detach(), w.detach(), dy)
    torch.testing.assert_close((gx, gr, gw), (want[0], want[0], want[1]),
                               atol=0, rtol=0)
    h, out = ops.add_rmsnorm(x, r, w)
    gx, gr = torch.autograd.grad(h, (x, r), dy)
    assert torch.equal(gx, dy) and torch.equal(gr, dy)


@pytest.mark.parametrize("name", ["stencil2d", "bitonic_stage",
                                  "bitonic_block"])
def test_wrappers_without_a_backward_still_refuse(plain_launchers, name):
    """MGMark's kernels have no backward: on the card an input that
    requires grad raises KernelBackwardMissing before anything launches."""
    x = torch.ones(16, requires_grad=True)
    call = {"stencil2d": lambda: ops.stencil2d(x.reshape(4, 4),
                                               torch.ones(3, 3)),
            "bitonic_stage": lambda: ops.bitonic_stage(x, 1, 2),
            "bitonic_block": lambda: ops.bitonic_block(x, 2)}[name]
    before = ops.launch_counts()
    with pytest.raises(ops.KernelBackwardMissing,
                       match=f"{name}: .*no backward.*No model trains"):
        call()
    assert ops.launch_counts() == before


def test_backward_kernels_refuse_a_double_backward(plain_launchers):
    """The backward kernels are not differentiable themselves: a second
    derivative through them raises instead of coming out wrong."""
    x = _rand((2, 16), 1, requires_grad=True)
    w = (1 + 0.3 * _rand((16,), 2)).requires_grad_(True)
    (gx,) = torch.autograd.grad(ops.rmsnorm(x, w).square().sum(), (x,),
                                create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        gx.sum().backward()


def test_layer_slices_unbind_each_stacked_leaf_once():
    """The model's layer loops take their slices with one unbind per
    stacked leaf (one stack of gradients in the backward, not one
    full-size zero-padded gradient per layer); the slices are
    layer_slice's."""
    from repro_torch.models import layers as L
    _, tp = shared_params(ARCH)
    n = get_config(ARCH).num_layers
    stacked = copy.deepcopy(tp["layers"])
    for t in optim.leaves(stacked):
        t.requires_grad_(True)
    slices = L.layer_slices(stacked, n)
    assert len(slices) == n
    for i, lp in enumerate(slices):
        for got, want in zip(optim.leaves(lp),
                             optim.leaves(L.layer_slice(tp["layers"], i))):
            assert torch.equal(got, want)
            assert type(got.grad_fn).__name__.startswith("UnbindBackward")
    with pytest.raises(ValueError, match="leading axis"):
        L.layer_slices(stacked, n + 1)
