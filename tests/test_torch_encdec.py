"""repro_torch's enc-dec family (whisper: a bidirectional encoder over
stub frame embeddings and a causal decoder with cross-attention) vs the
JAX reference on whisper-base-smoke (f32, CPU): configs, the param
tree's layout, the layers it adds (sinusoidal positions, the gelu MLP,
the non-causal plain flash against the reference's Pallas kernel),
forward, loss and gradients, prefill (the cross k/v included) + 8 greedy
decode steps, the residual adds fused into the norms, the Engine's
refusal, the launcher, and the train step traced on meta, smoke and
full.  Tolerances in tests/_torch_model_cases.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

import _torch_model_cases as cases  # noqa: E402
from _torch_parity import shared_params, spy_norms  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import api, get_config, layers  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ARCH = "whisper-base-smoke"


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


@pytest.mark.parametrize("arch", ["whisper-base", ARCH])
def test_config_matches_reference(arch):
    """The full config selects the flash kernel (hd = 64) where the
    reference selects "ref"; the smoke keeps "ref"."""
    cases.check_config(arch, flash=arch == "whisper-base")


def test_full_config_widths():
    cfg = get_config("whisper-base")
    assert (cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab_size,
            cfg.padded_vocab, cfg.encoder_seq, cfg.attn_impl) == \
        (6, 6, 512, 8, 8, 64, 2048, 51_865, 51_968, 1500, "flash")
    assert cfg.param_count() == 97_271_808


def test_init_matches_param_count_and_layout(params):
    """"encoder" and "decoder" stacks with the reference's keys, an
    untied lm_head, ln_enc and ln_f."""
    cases.check_layout(ARCH, params)
    cfg = get_config(ARCH)
    p = params[1]
    assert sorted(p) == ["decoder", "embed", "encoder", "lm_head", "ln_enc",
                         "ln_f"]
    assert sorted(p["decoder"]) == ["cross_attn", "ln1", "ln2", "ln3", "mlp",
                                    "self_attn"]
    assert p["encoder"]["mlp"]["w1"].shape == (cfg.encoder_layers,
                                               cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("S,d", [(16, 64), (1500, 512), (7, 6)])
def test_sinusoidal_pos_matches_jax(S, d):
    want = JL.sinusoidal_pos(S, d, jnp.float32)
    got = layers.sinusoidal_pos(S, d, torch.float32)
    cases.close(got, want, atol=1e-5, rtol=1e-5)
    rows = torch.tensor([0, 5, S - 1])
    cases.close(layers.sinusoidal_pos(0, d, torch.float32, positions=rows),
                np.asarray(want)[rows.numpy()], atol=1e-5, rtol=1e-5)
    assert layers.sinusoidal_pos(S, d, torch.bfloat16).dtype == torch.bfloat16


def test_gelu_mlp_matches_jax():
    """The tanh gelu of jax.nn.gelu's default (torch's default, erf,
    differs by up to about 1e-3 here)."""
    rng = np.random.default_rng(0)
    p = {"w1": rng.standard_normal((32, 48)).astype(np.float32) / 6,
         "w2": rng.standard_normal((48, 32)).astype(np.float32) / 7}
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    want = JL.gelu_mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = layers.gelu_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    cases.close(got, want, atol=1e-5, rtol=1e-5)
    erf = torch.nn.functional.gelu(torch.from_numpy(x @ p["w1"]))
    assert float((erf @ torch.from_numpy(p["w2"]) - got).abs().max()) > 1e-5


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [(2, 128, 256, 4, 4, 64),
                                             (1, 256, 128, 4, 2, 32)])
def test_noncausal_plain_flash_matches_the_pallas_kernel(B, Sq, Skv, H, K,
                                                         hd):
    """The plain version the CPU path (and the card's oracle) runs for
    the encoder and cross-attention, against the reference's Pallas
    kernel in interpret mode with causal=False, at Sq != Skv (multiples
    of its 128 block)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, interpret=True)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
    cases.close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(params, S):
    cases.check_forward(ARCH, params, S)


@pytest.mark.parametrize("S", [16, 37])
def test_flash_impl_matches_reference_forward(params, S):
    """attn_impl="flash" (the kernel wrapper, its plain version on the
    CPU) computes the reference's "ref" function, causal and not."""
    jp, tp = params
    cfg = get_config(ARCH).replace(attn_impl="flash")
    jb, tb = cases.both({"tokens": cases.tokens(ARCH, 2, S, seed=2),
                         **cases.modal(ARCH, 2)})
    from repro.models import api as japi
    from repro.models import get_config as jget_config
    want, _ = japi.forward(jp, jget_config(ARCH), jb)
    got, _ = api.forward(tp, cfg, tb)
    cases.close(got, want)
    plain, _ = api.forward(tp, cfg.replace(use_kernels=False), tb)
    assert torch.equal(plain, got)


def test_loss_and_grads_match_jax(params):
    cases.check_loss_and_grads(ARCH, params)


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(params, S):
    """k, v, xk, xv and pos after the prefill and after 8 greedy steps."""
    cases.check_prefill_decode(ARCH, params, S, steps=8)


def test_decode_clamps_its_position_as_the_reference_does(params):
    """Past the cache's last row the reference's dynamic_slice takes the
    last sinusoidal row and its update writes the last cache row: the
    port's step gives the same logits there."""
    jp, tp = params
    from repro.models import api as japi
    from repro.models import get_config as jget_config
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    jb, tb = cases.both({"tokens": cases.tokens(ARCH, 1, 6, seed=9),
                         **cases.modal(ARCH, 1)})
    want, jc = japi.prefill(jp, jcfg, japi.init_cache(jcfg, 1, 8), jb)
    got, tc = api.prefill(tp, cfg, api.init_cache(cfg, 1, 8, device="cpu"),
                          tb)
    for _ in range(4):                          # positions 6, 7, 8, 9
        nxt = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        want, jc = japi.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        got, tc = api.decode_step(tp, cfg, tc, torch.tensor(nxt).long())
        cases.close(got, want)


def test_decode_step_fuses_each_residual_add_into_a_norm(monkeypatch):
    """On the kernel path a decode step reaches one plain norm (the first
    layer's ln1) and 3 fused add+norms a layer (ln2, ln3 and the next
    ln1, the last into ln_f); a prefill adds the encoder's plain ln1 and
    its 2 a layer (ln_enc the last).  The plain path reaches no
    wrapper."""
    cfg = get_config(ARCH)
    p = api.init(0, cfg, device="cpu")
    tb = cases.both({"tokens": cases.tokens(ARCH, 2, 5, seed=7),
                     **cases.modal(ARCH, 2)})[1]
    L, Le = cfg.num_layers, cfg.encoder_layers
    for c, pre, dec in (
            (cfg, {"rmsnorm": 2, "add_rmsnorm": 2 * Le + 3 * L},
             {"rmsnorm": 1, "add_rmsnorm": 3 * L}),
            (cfg.replace(use_kernels=False), {}, {})):
        cache = api.init_cache(c, 2, 8, device="cpu")
        calls = spy_norms(monkeypatch)
        logits, cache = api.prefill(p, c, cache, tb)
        assert calls == pre
        calls.clear()
        api.decode_step(p, c, cache, logits.argmax(-1))
        assert calls == dec


def test_engine_refuses_the_family():
    """The Engine hands prefill only a prompt's tokens; the reference's
    fails at the first prefill, the port's at construction."""
    cfg = get_config(ARCH)
    with pytest.raises(ValueError, match="frames"):
        Engine(cfg, api.init(0, cfg, device="cpu"), device="cpu")


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_train_step_trace_matches_the_counts(impl):
    """One train step traced on meta: flash once per encoder layer and
    twice per decoder layer (self, cross) where selected, the norms (two
    plain, the rest fused with their residual add), each with its
    backward; the matrix-product FLOPs those of
    ``api.train_step_matmul_flops``."""
    cfg = get_config(ARCH).replace(attn_impl=impl)
    L, Le = cfg.num_layers, cfg.encoder_layers
    fwd = {"rmsnorm": 2, "add_rmsnorm": 2 * Le + 3 * L}
    if impl == "flash":
        fwd["flash_attention"] = Le + 2 * L
    want = {**fwd, **{k + "_bwd": v for k, v in fwd.items()}}
    kernels, mm = cases.traced_step(cfg, 2, 24)
    assert kernels == want
    assert mm == api.train_step_matmul_flops(cfg, 2, 24)


def test_full_train_step_traces_on_meta():
    """whisper-base's step at batch 8 x 448 (the card's phase 15 shape):
    flash and its backward in every encoder, self- and cross-attention
    block, FLOPs equal to the count."""
    cfg = get_config("whisper-base")
    kernels, mm = cases.traced_step(cfg, 8, 448)
    assert kernels["flash_attention_bwd"] == 18
    assert mm == api.train_step_matmul_flops(cfg, 8, 448)


def test_full_width_cache_layout():
    cfg = get_config("whisper-base")
    c = api.init_cache(cfg, 4, 448, device="meta")
    assert c["k"].shape == (6, 4, 448, 8, 64)
    assert c["xk"].shape == (6, 4, 1500, 8, 64)
    assert c["pos"].shape == ()


def test_launch_train_whisper_on_cpu_lowers_the_loss(capsys, tmp_path):
    """``launch.train`` takes the enc-dec through the registry and the
    fault-tolerant loop, its batches carrying frames."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                              "16", "--batch", "4", "--seq", "32",
                              "--lr", "3e-3",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[loop] step ")]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_make_batch_matches_the_reference():
    """``train.data.make_batch`` (copied) gives the reference's frames."""
    from repro.train.data import make_batch as jmake_batch
    from repro_torch.train.data import DataConfig, make_batch
    cell = DataConfig(vocab_size=0, seq_len=12, global_batch=3)
    want = jmake_batch(_jcfg(), cell, step=2)
    got = make_batch(get_config(ARCH), cell, step=2)
    assert sorted(got) == sorted(want) == ["frames", "targets", "tokens"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _jcfg():
    from repro.models import get_config as jget_config
    return jget_config(ARCH)
