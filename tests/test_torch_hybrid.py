"""repro_torch's hybrid family (zamba2: a Mamba2 backbone and one shared
attention block) vs the JAX reference on zamba2-7b-smoke (f32, CPU):
configs, the param tree's layout, forward, loss and gradients, prefill +
decode at a chunk-aligned and a ragged length, the serving engine token
for token, the residual adds fused into the norms, and the train step
traced on meta.  Tolerances in tests/_torch_model_cases.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import _torch_model_cases as cases  # noqa: E402
from _torch_parity import shared_params, spy_norms  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402

ARCH = "zamba2-7b-smoke"


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


@pytest.mark.parametrize("arch", ["zamba2-7b", ARCH])
def test_config_matches_reference(arch):
    """Field for field, attn_impl included: hd = 112 is no flash shape,
    so the full config keeps the reference's "ref"."""
    cases.check_config(arch, flash=False)


def test_full_config_widths():
    cfg = get_config("zamba2-7b")
    assert (cfg.num_layers, cfg.attn_every, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.hd, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.d_inner, cfg.attn_impl) == \
        (81, 6, 3584, 32, 32, 112, 112, 64, 64, 7168, "ref")
    assert cfg.param_count() == 6_751_130_832


def test_init_matches_param_count_and_layout(params):
    """(G, attn_every, ...) stacked SSM params plus an (R, ...) tail, and
    one unstacked shared block."""
    cases.check_layout(ARCH, params)
    cfg = get_config(ARCH)
    p = params[1]
    assert p["blocks"]["ssm"]["wz"].shape[:2] == (2, 2)
    assert p["tail"]["ssm"]["wz"].shape[0] == 1
    assert p["shared"]["attn"]["wq"].shape == (cfg.d_model, cfg.q_dim)
    assert p["shared"]["ln1"].shape == (cfg.d_model,)


def test_requires_grad_on_the_stacked_views():
    """The stacked leaves are views of one init tensor: each can still
    take a gradient of its own."""
    cfg = get_config(ARCH)
    p = api.init(0, cfg, device="cpu")
    leaf = p["blocks"]["ssm"]["wz"]
    leaf.requires_grad_(True)
    loss = api.loss(p, cfg, {k: torch.from_numpy(cases.tokens(ARCH, 1, 12))
                             .long() for k in ("tokens", "targets")})
    loss.backward()
    assert leaf.grad is not None and leaf.grad.shape == leaf.shape


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(params, S):
    cases.check_forward(ARCH, params, S)


def test_loss_and_grads_match_jax(params):
    cases.check_loss_and_grads(ARCH, params)


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(params, S):
    """S = 16 fills two SSD chunks of 8; 37 ends in a short chunk."""
    cases.check_prefill_decode(ARCH, params, S)


def test_continuous_batching_matches_jax(params):
    requests = [(0, [5, 6, 7], 6), (1, [1, 2, 3], 3), (2, [9, 9, 9], 8)]
    jout, tout, _, _ = cases.serve_both(ARCH, params, requests, slots=3,
                                        max_seq=48)
    assert tout == jout and len(tout) == 3


def test_slot_reuse_matches_jax(params):
    """7 requests on 2 slots: a reused slot's SSM states (batch axis 2),
    conv tails and shared-attention KV rows are overwritten at admission."""
    requests = cases.random_requests(ARCH, 7)
    jout, tout, jeng, teng = cases.serve_both(ARCH, params, requests,
                                              slots=2, max_seq=48)
    assert tout == jout and len(tout) == 7
    assert teng.stats() == jeng.stats()
    for key in ("ssm", "conv", "ssm_tail", "conv_tail"):
        cases.close(teng.cache[key], jeng.cache[key])


def test_launcher_serves_zamba2_on_cpu(capsys):
    assert launch_serve.main(["--arch", ARCH, "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_decode_step_fuses_each_residual_add_into_a_norm(monkeypatch):
    """On the kernel path a decode step reaches one plain norm (the first
    SSM layer's), a fused add+norm for every other norm (each SSM layer's,
    the shared block's two at each application, ln_f) and a gated norm
    per SSM layer; the plain path reaches no wrapper."""
    cfg = get_config(ARCH)
    params = api.init(0, cfg, device="cpu")
    toks = torch.from_numpy(cases.tokens(ARCH, 2, 5, seed=7)).long()
    n, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    for c, want in ((cfg, {"rmsnorm": 1, "add_rmsnorm": n + 2 * G,
                           "gated_rmsnorm": n}),
                    (cfg.replace(use_kernels=False), {})):
        cache = api.init_cache(c, 2, 8, device="cpu")
        logits, cache = api.prefill(params, c, cache, {"tokens": toks})
        calls = spy_norms(monkeypatch)
        api.decode_step(params, c, cache, logits.argmax(-1))
        assert calls == want


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_train_step_trace_matches_the_counts(impl):
    """One train step traced on meta: the SSD chunk and the gated norm
    once per SSM layer, the norms (one plain, the rest fused with their
    residual add), flash once per shared application where selected, each
    with its backward; the matrix-product FLOPs those of
    ``api.train_step_matmul_flops``."""
    cfg = get_config(ARCH).replace(attn_impl=impl)
    n, G = cfg.num_layers, cfg.num_layers // cfg.attn_every
    fwd = {"ssd_chunk_kernel": n, "gated_rmsnorm": n, "rmsnorm": 1,
           "add_rmsnorm": n + 2 * G}
    if impl == "flash":
        fwd["flash_attention"] = G
    want = {**fwd, **{k.replace("_kernel", "") + "_bwd": v
                      for k, v in fwd.items()}}
    kernels, mm = cases.traced_step(cfg, 2, 32)
    assert kernels == want
    assert mm == api.train_step_matmul_flops(cfg, 2, 32)


def test_full_width_cache_layout():
    """zamba2-7b's cache on meta: 13 KV caches, (13, 6, B, ...) states
    and a 3-layer tail."""
    cfg = get_config("zamba2-7b")
    c = api.init_cache(cfg, 4, 64, device="meta")
    assert c["k"].shape == (13, 4, 64, 32, 112)
    assert c["ssm"].shape == (13, 6, 4, 112, 64, 64)
    assert c["conv"].shape == (13, 6, 4, 3, 7168 + 128)
    assert c["ssm_tail"].shape == (3, 4, 112, 64, 64)
    assert c["ssm"].dtype == torch.float32
    assert np.prod(c["conv_tail"].shape) == 3 * 4 * 3 * 7296


def test_launch_train_zamba2_on_cpu_lowers_the_loss(capsys, tmp_path):
    """``launch.train`` takes the hybrid through the registry and the
    fault-tolerant loop."""
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


def test_ssm_train_step_flops_match_the_count():
    """``api.train_step_matmul_flops``'s SSM branch, which the hybrid
    shares, on mamba2-1.3b-smoke's traced step (32 tokens: 4 SSD chunks
    of 8); one chunk is refused, its carry-in term taking no gradient."""
    cfg = get_config("mamba2-1.3b-smoke")
    _, mm = cases.traced_step(cfg, 2, 32)
    assert mm == api.train_step_matmul_flops(cfg, 2, 32)
    with pytest.raises(ValueError, match="one SSD chunk"):
        api.train_step_matmul_flops(cfg, 2, 8)
