"""The chunked LM loss of repro_torch (``models/transformer.py
_chunked_xent``) against the reference's ``_chunked_xent`` and its
``jax.grad``, on the CPU from numpy inputs made from a seed, and
``loss_fn``'s switch to it at ``XENT_CHUNK_THRESHOLD``.

Tolerance (f32): the loss within 1e-5 and each gradient within 1e-5 of
its own max |g| (the same sums in another order in the two frameworks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import get_config as jget_config  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.models import api, get_config, transformer  # noqa: E402

from _torch_parity import shared_params  # noqa: E402

ARCH = "qwen2-1.5b-smoke"
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5


def _inputs(cfg, B, S, mask, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = (0.2 * rng.standard_normal((cfg.d_model, cfg.padded_vocab))
         ).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    m = ((rng.random((B, S)) < 0.7).astype(np.float32) if mask else None)
    return h, w, tgt, m


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


# (S, chunk, mask, vocab): S a multiple of the chunk or not (the pad
# path), the reference's chunk of 512 padded from S < 512, and a vocab
# below the padded one (the -1e30 columns)
CASES = [(37, 8, True, 256), (37, 8, False, 256), (32, 8, True, 256),
         (20, 512, False, 256), (29, 8, True, 250)]


@pytest.mark.parametrize("S,chunk,mask,vocab", CASES)
def test_chunked_xent_and_grads_match_jax(S, chunk, mask, vocab):
    B = 2
    jcfg = jget_config(ARCH).replace(vocab_size=vocab)
    cfg = get_config(ARCH).replace(vocab_size=vocab)
    assert cfg.padded_vocab == jcfg.padded_vocab == 256
    h, w, tgt, m = _inputs(cfg, B, S, mask)

    def jloss(h, w):
        return jtransformer._chunked_xent(
            {"lm_head": w}, jcfg, h, jnp.asarray(tgt),
            None if m is None else jnp.asarray(m), chunk=chunk)
    want, (want_dh, want_dw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))

    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    got = transformer._chunked_xent(
        {"lm_head": tw}, cfg, th, torch.from_numpy(tgt),
        None if m is None else torch.from_numpy(m), chunk=chunk)
    got_dh, got_dw = torch.autograd.grad(got, (th, tw))
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    assert _rel(got_dh.numpy(), np.asarray(want_dh)) <= GRAD_TOL
    assert _rel(got_dw.numpy(), np.asarray(want_dw)) <= GRAD_TOL


def test_chunked_xent_holds_no_whole_logits(monkeypatch):
    """Each chunk's unembed runs under checkpoint: the forward keeps no
    (B, chunk, Vp) logits for the backward, which makes them again."""
    cfg = get_config(ARCH)
    h, w, tgt, _ = _inputs(cfg, 2, 24, False)
    calls = []
    real = transformer.L.unembed

    def spy(p, hc, cfg):
        calls.append(tuple(hc.shape))
        return real(p, hc, cfg)
    monkeypatch.setattr(transformer.L, "unembed", spy)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss = transformer._chunked_xent({"lm_head": tw}, cfg, th,
                                     torch.from_numpy(tgt), chunk=8)
    assert calls == [(2, 8, cfg.d_model)] * 3
    loss.backward()
    assert calls == [(2, 8, cfg.d_model)] * 6


@pytest.mark.parametrize("above", [True, False])
def test_loss_fn_chunks_exactly_at_the_threshold(monkeypatch, above):
    """With the threshold lowered to padded_vocab * S (or one above it),
    ``loss_fn`` takes the chunked path (or not); either way the loss is
    the reference ``loss_fn``'s within LOSS_TOL."""
    jp, tp = shared_params(ARCH)
    cfg = get_config(ARCH)
    B, S = 2, 19
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    monkeypatch.setattr(transformer, "XENT_CHUNK_THRESHOLD",
                        cfg.padded_vocab * S + (0 if above else 1))
    chunked = []
    real = transformer._chunked_xent
    monkeypatch.setattr(transformer, "_chunked_xent",
                        lambda *a, **k: chunked.append(1) or real(*a, **k))
    got = api.loss(tp, cfg, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert chunked == ([1] if above else [])
    from repro.models import api as japi
    want = japi.loss(jp, jget_config(ARCH),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= LOSS_TOL


def test_threshold_is_the_reference_s():
    """2^26 and chunks of 512, as ``repro/models/transformer.py:166``;
    qwen2-1.5b at S = 1024 is past it."""
    assert transformer.XENT_CHUNK_THRESHOLD == 1 << 26
    assert transformer.XENT_CHUNK == 512
    assert get_config("qwen2-1.5b").padded_vocab * 1024 >= 1 << 26
