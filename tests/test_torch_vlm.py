"""repro_torch's VLM family (llava: stub patch embeddings prepended to the
text, on the dense transformer backbone) vs the JAX reference on
llava-next-34b-smoke (f32, CPU): configs, the param tree's layout,
forward over patches and text, the loss on the text positions and its
gradients, prefill + 8 greedy decode steps, the Engine's refusal, the
launcher, and the train step traced on meta, smoke and full.  Tolerances
in tests/_torch_model_cases.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import _torch_model_cases as cases  # noqa: E402
from _torch_parity import shared_params  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.models import api, get_config, transformer  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

ARCH = "llava-next-34b-smoke"


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


@pytest.mark.parametrize("arch", ["llava-next-34b", ARCH])
def test_config_matches_reference(arch):
    """The full config selects the flash kernel (hd = 128) where the
    reference selects "ref"; the smoke keeps "ref"."""
    cases.check_config(arch, flash=arch == "llava-next-34b")


def test_full_config_widths():
    """34.39e9 params, 68.78 GB in bf16; a token of KV cache takes
    2 x 60 layers x 8 heads x 128 x 2 B."""
    cfg = get_config("llava-next-34b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.num_patches,
            cfg.rope_theta, cfg.attn_impl) == \
        (60, 7168, 56, 8, 128, 20_480, 64_000, 2880, 5e6, "flash")
    assert cfg.param_count() == 34_388_917_248
    assert 2 * cfg.num_layers * cfg.kv_dim * 2 == 245_760


def test_init_matches_param_count_and_layout(params):
    """The dense transformer's tree: nothing holds the patches."""
    cases.check_layout(ARCH, params)
    assert sorted(params[1]) == ["embed", "layers", "lm_head", "ln_f"]


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(params, S):
    """Logits at every position, the patches' rows first."""
    cases.check_forward(ARCH, params, S)


@pytest.mark.parametrize("S", [16, 37])
def test_flash_impl_matches_reference_forward(params, S):
    """attn_impl="flash" (the kernel wrapper, its plain version on the
    CPU) computes the reference's "ref" function over patches + text."""
    jp, tp = params
    cfg = get_config(ARCH).replace(attn_impl="flash")
    jb, tb = cases.both({"tokens": cases.tokens(ARCH, 2, S, seed=2),
                         **cases.modal(ARCH, 2)})
    want, _ = japi.forward(jp, jget_config(ARCH), jb)
    got, _ = api.forward(tp, cfg, tb)
    cases.close(got, want)
    plain, _ = api.forward(tp, cfg.replace(use_kernels=False), tb)
    assert torch.equal(plain, got)


def test_loss_and_grads_match_jax(params):
    """The loss on the text positions only (targets and mask of the text's
    length), and every gradient."""
    cases.check_loss_and_grads(ARCH, params)


def test_loss_takes_the_text_positions_only(params):
    """The loss equals the cross-entropy of the forward's last S rows."""
    _, tp = params
    cfg = get_config(ARCH)
    toks = cases.tokens(ARCH, 2, 10, seed=5)
    tb = cases.both({"tokens": toks, "targets": np.roll(toks, -1, axis=1),
                     **cases.modal(ARCH, 2)})[1]
    logits, _ = api.forward(tp, cfg, tb)
    assert logits.shape[1] == cfg.num_patches + 10
    from repro_torch.models import layers
    want = layers.cross_entropy(logits[:, -10:], tb["targets"])
    assert abs(float(api.loss(tp, cfg, tb)) - float(want)) < 1e-6


def test_chunked_loss_switch_counts_the_text_positions(monkeypatch, params):
    """The chunked cross-entropy is taken from padded_vocab x (text
    positions) on, as the reference tests it on the sliced h: with the
    threshold at 256 x 24, 24 text tokens chunk and 23 do not, whatever
    the patches add."""
    _, tp = params
    cfg = get_config(ARCH)
    monkeypatch.setattr(transformer, "XENT_CHUNK_THRESHOLD",
                        cfg.padded_vocab * 24)
    seen = []
    real = transformer._chunked_xent
    monkeypatch.setattr(transformer, "_chunked_xent",
                        lambda *a, **k: seen.append(a[2].shape[1])
                        or real(*a, **k))
    for S in (23, 24):
        toks = cases.tokens(ARCH, 1, S, seed=6)
        tb = cases.both({"tokens": toks, "targets": toks,
                         **cases.modal(ARCH, 1)})[1]
        api.loss(tp, cfg, tb)
    assert seen == [24]


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(params, S):
    """The cache holds the patches' rows first: pos = num_patches + S
    after the prefill; 8 greedy steps on."""
    cases.check_prefill_decode(ARCH, params, S, max_seq=64, steps=8)


def test_engine_refuses_the_family():
    cfg = get_config(ARCH)
    with pytest.raises(ValueError, match="patches"):
        Engine(cfg, api.init(0, cfg, device="cpu"), device="cpu")


def test_train_step_trace_matches_the_counts():
    """One train step traced on meta over 8 patches + 24 tokens: the norms
    (one plain, the rest fused with their residual add) and their
    backward; the FLOPs those of ``api.train_step_matmul_flops``, whose
    "ref" attention products run over patches + text."""
    cfg = get_config(ARCH)
    L = cfg.num_layers
    fwd = {"rmsnorm": 1, "add_rmsnorm": 2 * L}
    kernels, mm = cases.traced_step(cfg, 2, 24)
    assert kernels == {**fwd, **{k + "_bwd": v for k, v in fwd.items()}}
    assert mm == api.train_step_matmul_flops(cfg, 2, 24)


def test_full_train_step_traces_on_meta():
    """llava-next-34b's step on meta at batch 1 x (2880 patches + 256
    tokens): flash once a layer and its backward, FLOPs equal to the
    count (the unembedding over the 256 text positions only)."""
    cfg = get_config("llava-next-34b")
    kernels, mm = cases.traced_step(cfg, 1, 256)
    assert kernels["flash_attention"] == kernels["flash_attention_bwd"] \
        == cfg.num_layers
    assert mm == api.train_step_matmul_flops(cfg, 1, 256)
    text_only = api.train_step_matmul_flops(cfg.replace(num_patches=0), 1,
                                            256)
    per_token = 3 * 2 * cfg.num_layers * (
        cfg.d_model * (2 * cfg.q_dim + 2 * cfg.kv_dim) + 3 * cfg.d_model
        * cfg.d_ff)
    assert mm - text_only == 2880 * per_token


def test_launch_train_llava_on_cpu_lowers_the_loss(capsys, tmp_path):
    """``launch.train`` takes the VLM through the registry and the loop,
    its batches carrying patches (``--seq`` counts patches and text)."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                              "16", "--batch", "4", "--seq", "40",
                              "--lr", "3e-3",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[loop] step ")]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_make_batch_matches_the_reference():
    """``train.data.make_batch`` (copied) gives the reference's patches
    and a text of seq_len - num_patches tokens."""
    from repro.train.data import make_batch as jmake_batch
    from repro_torch.train.data import DataConfig, make_batch
    cell = DataConfig(vocab_size=0, seq_len=20, global_batch=3)
    want = jmake_batch(jget_config(ARCH), cell, step=1)
    got = make_batch(get_config(ARCH), cell, step=1)
    assert sorted(got) == sorted(want) == ["patches", "targets", "tokens"]
    assert got["tokens"].shape == (3, 12)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
