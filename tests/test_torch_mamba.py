"""repro_torch's SSM family vs the JAX reference on mamba2-1.3b-smoke (f32,
CPU): configs, params, forward, loss, prefill + cache, decode steps, and
the serving engine token for token.

Tolerance: atol/rtol 1e-4 on logits and states (f32 model, sums taken
in another order)."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import api, get_config, list_archs  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

from _torch_parity import shared_params, spy_norms  # noqa: E402

ARCH = "mamba2-1.3b-smoke"
ATOL, RTOL = 1e-4, 1e-4
F32_LEAVES = {"conv_xw", "conv_xb", "conv_bcw", "conv_bcb", "A_log", "D",
              "dt_bias"}


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, get_config(ARCH).vocab_size, (B, S)).astype(np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mamba2-1.3b-smoke"])
def test_config_matches_reference(arch):
    """Every field the port keeps equals the reference's, as do the
    derived SSM widths and the parameter count."""
    mine, ref = get_config(arch), jget_config(arch)
    for f in dataclasses.fields(mine):
        if f.name != "use_kernels":
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("padded_vocab", "d_inner", "ssm_heads", "ssm_groups",
                 "conv_dim", "in_proj_dim"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.param_count() == ref.param_count()
    assert arch in list_archs()


def test_full_config_widths():
    cfg = get_config("mamba2-1.3b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups,
            cfg.ssm_conv_width, cfg.ssm_chunk, cfg.vocab_size, cfg.dtype) \
        == (48, 2048, 4096, 64, 64, 128, 1, 4, 256, 50_280, "bfloat16")


def test_init_matches_param_count_and_layout(params):
    cfg = get_config(ARCH)
    mine = api.init(0, cfg, device="cpu")
    assert api.param_count(mine) == cfg.param_count()
    _, converted = params

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in tree.items()}
    assert shapes(mine) == shapes(converted)
    ssm = mine["layers"]["ssm"]
    a = torch.exp(ssm["A_log"])
    assert torch.all((a >= 1) & (a <= 16))
    dt0 = torch.nn.functional.softplus(ssm["dt_bias"])
    assert torch.all((dt0 > 0.9e-3) & (dt0 < 0.11))
    again = api.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(ssm["wx"], again["layers"]["ssm"]["wx"])


def test_bf16_tree_converts_with_f32_ssm_leaves():
    """params_from_jax carries the mamba tree over leaf by leaf: the conv
    weights, A_log, D and dt_bias stay f32, the rest is bf16."""
    cfg = jget_config(ARCH).replace(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(2), cfg))
    got = params_from_jax(tree, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        t = got
        for key in path:
            t = t[key.key]
        name = path[-1].key
        assert t.dtype == (torch.float32 if name in F32_LEAVES
                           else torch.bfloat16), name
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))


# ---------------------------------------------------------------------------
# forward, loss, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(params, S, use_kernels):
    """Both SSD paths (the chunk kernel's wrapper, and the plain
    ssd_reference); S=37 is ragged against the smoke chunk of 8."""
    jp, tp = params
    cfg = get_config(ARCH).replace(use_kernels=use_kernels)
    toks = _tokens(2, S)
    want, _ = japi.forward(jp, jget_config(ARCH),
                           {"tokens": jnp.asarray(toks)})
    got, aux = api.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, cfg.padded_vocab) and aux == 0.0
    _close(got, want)


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


@pytest.mark.parametrize("S", [1, 2, 5, 19])
def test_prefill_cache_and_decode_match_jax(params, S):
    """Prompts shorter than the conv width's W-1 = 3 leave a zero-padded
    conv tail; 19 tokens cross two chunk boundaries."""
    jp, tp = params
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    max_seq, B = 64, 2
    toks = _tokens(B, S, seed=4)
    jc = japi.init_cache(jcfg, B, max_seq)
    want, jc = japi.prefill(jp, jcfg, jc, {"tokens": jnp.asarray(toks)})
    tc = api.init_cache(cfg, B, max_seq, device="cpu")
    got, tc = api.prefill(tp, cfg, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    for key in ("ssm", "conv"):
        assert tc[key].shape == jc[key].shape and tc[key].dtype == \
            torch.float32
        _close(tc[key], jc[key])
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        want, jc = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        got, tc = api.decode_step(tp, cfg, tc, torch.tensor(nxt).long())
        _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 8
    _close(tc["ssm"], jc["ssm"])
    _close(tc["conv"], jc["conv"])


def test_decode_continues_forward(params):
    """Prefill of a prefix and decode of the rest give the forward pass's
    logits at every later position (the state carries the sequence)."""
    _, tp = params
    cfg = get_config(ARCH)
    toks = torch.from_numpy(_tokens(1, 14, seed=5)).long()
    full, _ = api.forward(tp, cfg, {"tokens": toks})
    cache = api.init_cache(cfg, 1, 32, device="cpu")
    logits, cache = api.prefill(tp, cfg, cache, {"tokens": toks[:, :6]})
    _close(logits, full[:, 5].numpy())
    for t in range(6, 14):
        logits, cache = api.decode_step(tp, cfg, cache, toks[:, t])
        _close(logits, full[:, t].numpy())


@pytest.mark.parametrize("arch", [ARCH, "qwen2-1.5b-smoke"])
def test_kernel_path_hands_rmsnorm_contiguous_rows(monkeypatch, arch):
    """The rmsnorm kernel takes contiguous rows only.  A batch-2 prefill
    normalises the strided last position ``h[:, -1:]``; on the card that
    raised until ``layers.rms_norm`` copied it first."""
    from repro_torch.kernels import ops
    seen = []
    real = ops.rmsnorm

    def strict(x, w, eps=1e-6):
        seen.append(x.is_contiguous())
        return real(x, w, eps)
    monkeypatch.setattr(ops, "rmsnorm", strict)
    cfg = get_config(arch)
    params = api.init(0, cfg, device="cpu")
    cache = api.init_cache(cfg, 2, 16, device="cpu")
    toks = torch.from_numpy(_tokens(2, 7, seed=6)).long()
    logits, cache = api.prefill(params, cfg, cache, {"tokens": toks})
    api.decode_step(params, cfg, cache, logits.argmax(-1))
    assert seen and all(seen)


def test_cuda_default_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    cfg = get_config(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------

def _serve(params, requests, **kw):
    """The same requests through the JAX Engine and the port's, drained;
    returns (jax outputs, port outputs, jax engine, port engine)."""
    jp, tp = params
    engines = (JEngine(jget_config(ARCH), jp, **kw),
               Engine(get_config(ARCH), tp, device="cpu", **kw))
    outs = []
    for eng, cls in zip(engines, (JRequest, Request)):
        for uid, prompt, n in requests:
            eng.submit(cls(uid=uid, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=n))
        outs.append({r.uid: r.output for r in eng.run_until_drained()})
    return (*outs, *engines)


def test_continuous_batching_matches_jax(params):
    """tests/test_serve.py::test_continuous_batching_exact's requests:
    three slots, admitted while others decode."""
    requests = [(0, [5, 6, 7, 8], 6), (1, [1, 2], 3), (2, [9, 9, 9], 8)]
    jout, tout, _, _ = _serve(params, requests, slots=3, max_seq=48)
    assert tout == jout and len(tout) == 3


def test_slot_reuse_matches_jax(params):
    """7 requests on 2 slots: a reused slot's SSM state and conv tail are
    overwritten at admission, whatever the idle slot decoded meanwhile."""
    rng = np.random.default_rng(0)
    cfg = get_config(ARCH)
    requests = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(1, 12))),
                 int(rng.integers(1, 7))) for i in range(7)]
    jout, tout, jeng, teng = _serve(params, requests, slots=2, max_seq=48)
    assert tout == jout and len(tout) == 7
    assert teng.stats() == jeng.stats()
    _close(teng.cache["ssm"], jeng.cache["ssm"])
    _close(teng.cache["conv"], jeng.cache["conv"])


def test_launcher_serves_mamba_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_decode_step_fuses_the_residual_add_and_the_gate(monkeypatch):
    """On the kernel path a decode step reaches one plain norm, one fused
    add+norm a layer (the last into ln_f) and one gated norm a layer: the
    residual add, silu(z) and y * silu(z) are no launches of their own."""
    cfg = get_config(ARCH)
    params = api.init(0, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(2, 5, seed=7)).long()
    n = cfg.num_layers
    for c, want in ((cfg, {"rmsnorm": 1, "add_rmsnorm": n,
                           "gated_rmsnorm": n}),
                    (cfg.replace(use_kernels=False), {})):
        cache = api.init_cache(c, 2, 8, device="cpu")
        logits, cache = api.prefill(params, c, cache, {"tokens": toks})
        calls = spy_norms(monkeypatch)
        api.decode_step(params, c, cache, logits.argmax(-1))
        assert calls == want


def test_serve_llm_example_on_cpu():
    """examples/serve_llm_torch.py: 12 requests of the reference's example
    through 4 slots, each answered within its budget."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / \
        "serve_llm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_llm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    done = mod.main(["--device", "cpu"])
    assert len(done) == 12 and all(1 <= len(r.output) <= 15 for r in done)
