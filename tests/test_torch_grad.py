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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402
from repro_torch.train import optim  # noqa: E402

from _torch_parity import shared_params  # noqa: E402

ARCH = "qwen2-1.5b-smoke"
F32 = dict(atol=1e-5, rtol=1e-4)
LEAF_TOL = 1e-4


def _rand(shape, seed, dtype=torch.float32, requires_grad=False):
    x = np.random.default_rng(seed).standard_normal(shape)
    return torch.tensor(x, dtype=dtype, requires_grad=requires_grad)


def _grads(params, cfg, batch):
    p = copy.deepcopy(params)
    flat = optim.leaves(p)
    for t in flat:
        t.requires_grad_(True)
    loss = api.loss(p, cfg, batch)
    return loss.detach(), optim.unflatten(p, torch.autograd.grad(loss, flat))


def _assert_leaves_close(got, want, tol=LEAF_TOL):
    """Each leaf within tol * its max |want|."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == len(optim.leaves(got))
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        w = np.asarray(w, np.float32)
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (path, err, np.abs(w).max())


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
    _assert_leaves_close(got, want)


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
    return lse_flags


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


def test_wrappers_without_a_backward_still_refuse(plain_launchers):
    w = torch.ones(8, requires_grad=True)
    x = torch.ones(2, 8)
    with pytest.raises(RuntimeError, match="no backward.*mamba training"):
        ops.gated_rmsnorm(x, x, w)


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
