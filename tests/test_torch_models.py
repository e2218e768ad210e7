"""repro_torch models vs the JAX reference on qwen2-1.5b-smoke (f32, CPU):
configs, forward, loss, prefill + cache, decode steps."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.models import api, get_config, list_archs  # noqa: E402

from _torch_parity import shared_params, spy_norms  # noqa: E402

ARCH = "qwen2-1.5b-smoke"
ATOL, RTOL = 1e-4, 1e-4          # f32 model, sums taken in another order


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


def _tokens(B, S, seed=1):
    cfg = get_config(ARCH)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-1.5b-smoke"])
def test_config_matches_reference(arch):
    """Every architecture field the port keeps equals the reference's;
    only attn_impl differs on the full config (flash for blocked)."""
    mine, ref = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(mine):
        if f.name in ("use_kernels",):
            continue
        want = getattr(ref, f.name)
        if f.name == "attn_impl" and arch == "qwen2-1.5b":
            assert (mine.attn_impl, want) == ("flash", "blocked")
            continue
        assert getattr(mine, f.name) == want, f.name
    for prop in ("padded_vocab", "hd", "q_dim", "kv_dim"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.param_count() == ref.param_count()
    assert mine.torch_dtype == getattr(torch, ref.dtype)
    assert arch in list_archs()


def test_full_config_widths():
    cfg = get_config("qwen2-1.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        (28, 1536, 12, 2, 128, 8960, 151_936, "bfloat16")
    assert cfg.param_count() == 1_777_088_000


def test_init_matches_param_count_and_layout(params):
    cfg = get_config(ARCH)
    mine = api.init(0, cfg, device="cpu")
    assert api.param_count(mine) == cfg.param_count()
    _, converted = params

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in tree.items()}
    assert shapes(mine) == shapes(converted)
    # norms start at 1, biases at 0, as in the reference
    assert torch.all(mine["layers"]["ln1"] == 1)
    assert torch.all(mine["layers"]["attn"]["bq"] == 0)
    again = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(mine["embed"], again["embed"])


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(params, S):
    jp, tp = params
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    toks = _tokens(2, S)
    want, _ = japi.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, cfg.padded_vocab) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("S", [16, 37])
def test_flash_impl_matches_reference_forward(params, S):
    """attn_impl="flash" (the kernel wrapper, its plain version on the
    CPU) computes the reference's function."""
    jp, tp = params
    cfg = get_config(ARCH).replace(attn_impl="flash")
    toks = _tokens(1, S, seed=2)
    want, _ = japi.forward(jp, jget_config(ARCH), {"tokens": jnp.asarray(toks)})
    got, _ = api.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    plain, _ = api.forward(tp, cfg.replace(use_kernels=False),
                           {"tokens": torch.from_numpy(toks)})
    assert torch.equal(plain, got)


def test_loss_matches_jax(params):
    jp, tp = params
    toks = _tokens(2, 24, seed=3)
    tgt = np.roll(toks, -1, axis=1)
    mask = (np.arange(24) < 20).astype(np.float32)[None].repeat(2, 0)
    want = japi.loss(jp, jget_config(ARCH),
                     {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
                      "mask": jnp.asarray(mask)})
    got = api.loss(tp, get_config(ARCH),
                   {"tokens": torch.from_numpy(toks),
                    "targets": torch.from_numpy(tgt),
                    "mask": torch.from_numpy(mask)})
    assert abs(float(got) - float(want)) < ATOL


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(params, S):
    jp, tp = params
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    max_seq, B = 64, 2
    toks = _tokens(B, S, seed=4)
    jc = japi.init_cache(jcfg, B, max_seq)
    want, jc = japi.prefill(jp, jcfg, jc, {"tokens": jnp.asarray(toks)})
    tc = api.init_cache(cfg, B, max_seq, device="cpu")
    got, tc = api.prefill(tp, cfg, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        want, jc = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        got, tc = api.decode_step(tp, cfg, tc, torch.tensor(nxt).long())
        _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 8
    _close(tc["k"], jc["k"])


def test_unknown_family_raises():
    """Every family of the reference runs (each in its own file); a family
    that neither package has raises from ``api.module_for``, naming the
    six."""
    assert sorted(api._FAMILY) == sorted(japi._FAMILY) == [
        "dense", "encdec", "hybrid", "moe", "ssm", "vlm"]
    cfg = get_config(ARCH).replace(family="rwkv")
    with pytest.raises(ValueError, match="rwkv") as err:
        api.module_for(cfg)
    assert all(f in str(err.value) for f in api._FAMILY)
    with pytest.raises(ValueError, match="rwkv"):
        api.init(0, cfg, device="cpu")


def test_cuda_default_raises_without_gpu():
    """Entry points default to the card and never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 8)


def test_decode_step_fuses_each_residual_add_into_a_norm(monkeypatch):
    """On the kernel path a decode step reaches one plain norm (the first
    block's) and 2 fused add+norms a layer (the last into ln_f): the 2L
    residual adds are no launches of their own.  The plain path reaches
    no wrapper."""
    cfg = get_config(ARCH)
    params = api.init(0, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 5, seed=7)).long()
    for c, want in ((cfg, {"rmsnorm": 1, "add_rmsnorm": 2 * cfg.num_layers}),
                    (cfg.replace(use_kernels=False), {})):
        cache = api.init_cache(c, 2, 8, device="cpu")
        logits, cache = api.prefill(params, c, cache, {"tokens": toks})
        calls = spy_norms(monkeypatch)
        api.decode_step(params, c, cache, logits.argmax(-1))
        assert calls == want
