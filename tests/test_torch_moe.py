"""repro_torch's MoE family vs the JAX reference (f32, CPU).

``repro_torch.models.moe`` function by function against
``repro.models.moe`` (tests/test_moe.py's six tests ported, each held to
the JAX function; routing indices, dispatch slots, positions and keep
flags exactly equal, with drops and with exactly tied probabilities;
both branches of ``moe_ffn``), then qwen3-moe-30b-a3b-smoke and
dbrx-132b-smoke through ``api``: forward, loss with the load-balancing
term, gradients, prefill + decode at a group-aligned and a ragged length,
the serving engine token for token, and the smoke train steps traced on
meta.  Values: ATOL / RTOL 1e-4 (tests/_torch_model_cases.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import _torch_model_cases as cases  # noqa: E402
from _torch_parity import shared_params  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import api, get_config, layers  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b-smoke", "dbrx-132b-smoke"]
CFG_ARCH = "dbrx-132b-smoke"         # tests/test_moe.py's


def _moe_params(arch=CFG_ARCH, seed=3, **widths):
    """One layer's MoE params from the reference's init_moe, both ways,
    at the config's widths (or those given)."""
    jp = JM.init_moe(jax.random.PRNGKey(seed),
                     jget_config(arch).replace(dtype="float32", **widths))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _x(T, d, seed=0):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(
        np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the functions, against repro.models.moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 8, 74, 1024, 2048])
def test_capacity_is_mxu_padded(tokens):
    cfg = get_config(CFG_ARCH)
    assert M.capacity(tokens, cfg) == JM.capacity(tokens, jget_config(CFG_ARCH))
    assert M.capacity(tokens, cfg) % 8 == 0
    assert M.capacity(tokens, cfg) >= tokens * cfg.experts_per_token \
        / cfg.num_experts


@pytest.mark.parametrize("arch", [CFG_ARCH, "qwen3-moe-30b-a3b"])
def test_route_topk_normalized_matches_jax(arch):
    """Random tokens: the same experts in the same order, gates summing to
    1, and the aux term, as the reference's."""
    cfg = get_config(arch).replace(d_model=64, d_ff=32, dtype="float32")
    jp, tp = _moe_params(arch, seed=5, d_model=64, d_ff=32)
    x = _x(64, 64)
    idx, w, aux = M.route(tp, torch.from_numpy(x), cfg)
    jidx, jw, jaux = JM.route(jp, jnp.asarray(x), jget_config(arch))
    assert idx.shape == (64, cfg.experts_per_token) and idx.dtype == torch.int32
    _eq(idx, jidx)
    cases.close(w, jw)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) < cases.ATOL and float(aux) > 0


def test_route_breaks_exact_ties_to_the_lower_index():
    """A router with repeated columns gives exactly equal probabilities:
    jax.lax.top_k takes the lower index first, and so must the port."""
    cfg = get_config(CFG_ARCH)
    jp, tp = _moe_params()
    r = np.asarray(jp["router"])
    r = np.repeat(r[:, :2], 2, axis=1)          # experts 0=1 and 2=3
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r.copy()))
    x = _x(32, cfg.d_model, seed=1)
    x[:8] = 0.0                                 # all four experts tied
    idx, _, _ = M.route(tp, torch.from_numpy(x), cfg)
    jidx, _, _ = JM.route(jp, jnp.asarray(x), jget_config(CFG_ARCH))
    _eq(idx, jidx)
    assert (idx[:8] == torch.tensor([0, 1], dtype=torch.int32)).all()
    assert bool((idx[8:, 0] // 2 == idx[8:, 1] // 2).all())


@pytest.mark.parametrize("case", ["unique", "drops", "random"])
def test_build_dispatch_matches_jax(case):
    """tests/test_moe.py's two dispatch cases (positions unique per
    expert; capacity drops the excess) and a random one with drops:
    dispatch_idx, pos and keep exactly the reference's."""
    if case == "unique":
        idx, T, E, C = np.array([[0, 1], [0, 2], [0, 3], [1, 2]]), 4, 4, 8
    elif case == "drops":
        idx, T, E, C = np.zeros((10, 1), np.int64), 10, 2, 4
    else:
        rng = np.random.default_rng(2)
        T, E, C = 40, 6, 8
        idx = np.stack([rng.permutation(E)[:3] for _ in range(T)])
    got = M.build_dispatch(torch.from_numpy(idx).int(), T, E, C)
    want = JM.build_dispatch(jnp.asarray(idx, jnp.int32), T, E, C)
    for g, w in zip(got, want):
        _eq(g, w)
    dispatch, pos, keep = got
    taken = [(int(e), int(p)) for e, p in zip(idx.reshape(-1), pos) if p < C]
    assert len(taken) == len(set(taken))
    if case == "drops":
        assert int(keep.sum()) == 4 and int((dispatch[0] < T).sum()) == 4
    if case == "random":
        assert not bool(keep.all())


@pytest.mark.parametrize("T", [32, 30])
def test_moe_ffn_matches_jax_on_both_branches(T):
    """T = 32 (a multiple of moe_groups = 4) runs grouped_moe_ffn, T = 30
    the global dispatch, in both packages; capacity_factor 1 so groups
    and experts overflow."""
    cfg = get_config(CFG_ARCH).replace(capacity_factor=1.0)
    jcfg = jget_config(CFG_ARCH).replace(capacity_factor=1.0)
    jp, tp = _moe_params()
    x = _x(T, cfg.d_model, seed=4)
    y, aux = M.moe_ffn(tp, torch.from_numpy(x), cfg)
    jy, jaux = JM.moe_ffn(jp, jnp.asarray(x), jcfg)
    cases.close(y, jy)
    assert abs(float(aux) - float(jaux)) < cases.ATOL
    if T % cfg.moe_groups == 0:
        gy, gaux = M.grouped_moe_ffn(tp, torch.from_numpy(x), cfg)
        assert torch.equal(gy, y) and torch.equal(gaux, aux)


def test_dispatch_local_and_combine_local_match_jax():
    cfg = get_config(CFG_ARCH)
    jp, tp = _moe_params()
    x = _x(24, cfg.d_model, seed=6)
    xe, meta, aux = M.dispatch_local(tp, torch.from_numpy(x), cfg, 8)
    jxe, jmeta, jaux = JM.dispatch_local(jp, jnp.asarray(x),
                                         jget_config(CFG_ARCH), 8)
    cases.close(xe, jxe)
    for g, w in zip(meta, jmeta):      # expert_idx, gate_w, pos_c, keep
        if g.dtype == torch.float32:
            cases.close(g, w)
        else:
            _eq(g, w)
    ye = torch.from_numpy(_x(cfg.num_experts * 8, cfg.d_model, 7)).reshape(
        cfg.num_experts, 8, cfg.d_model)
    cases.close(M.combine_local(ye, meta, cfg),
                JM.combine_local(jnp.asarray(ye.numpy()), jmeta,
                                 jget_config(CFG_ARCH)))


@pytest.mark.parametrize("seed", [0, 17])
def test_moe_identity_when_experts_identical(seed):
    """tests/test_moe.py's property at two seeds: with every expert equal
    to expert 0 and nothing dropped, MoE(x) == f(x), as in the
    reference."""
    cap = (get_config(CFG_ARCH).num_experts
           / get_config(CFG_ARCH).experts_per_token)
    cfg = get_config(CFG_ARCH).replace(capacity_factor=float(cap))
    jcfg = jget_config(CFG_ARCH).replace(capacity_factor=float(cap))
    jp, tp = _moe_params(seed=seed)
    for k in ("wg", "wu", "wd"):
        tp[k] = tp[k][:1].expand_as(tp[k]).contiguous()
        jp[k] = jnp.broadcast_to(jp[k][:1], jp[k].shape)
    x = _x(32, cfg.d_model, seed=seed)
    y, _ = M.moe_ffn(tp, torch.from_numpy(x), cfg)
    ref = M.expert_ffn({k: tp[k][:1] for k in ("wg", "wu", "wd")},
                       torch.from_numpy(x)[None])[0]
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4, rtol=1e-3)
    cases.close(y, JM.moe_ffn(jp, jnp.asarray(x), jcfg)[0])


def test_moe_grads_flow_to_router_and_experts():
    """Gradients of sum(moe_ffn(x)) against jax.grad, leaf by leaf; the
    router's and the experts' are non-zero."""
    cfg = get_config(CFG_ARCH)
    jp, tp = _moe_params()
    x = _x(16, cfg.d_model, seed=8)
    want = jax.jit(jax.grad(lambda p: JM.moe_ffn(
        p, jnp.asarray(x), jget_config(CFG_ARCH))[0].sum()))(jp)
    for t in tp.values():
        t.requires_grad_(True)
    M.moe_ffn(tp, torch.from_numpy(x), cfg)[0].sum().backward()
    for k, w in want.items():
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(w),
                                   atol=cases.ATOL, rtol=cases.RTOL)
    assert float(tp["router"].grad.abs().sum()) > 0
    assert float(tp["wd"].grad.abs().sum()) > 0


def test_moe_traces_on_meta():
    """Capacities come from shapes and nothing reads the device: the
    grouped and the global dispatch both run on meta tensors."""
    cfg = get_config("qwen3-moe-30b-a3b")
    gen = layers.generator(0, torch.device("meta"))
    p = layers.unstack(M.init_moe(gen, cfg, 1))
    for T in (2048, 1000):
        y, aux = M.moe_ffn(p, torch.empty((T, cfg.d_model), device="meta",
                                          dtype=torch.bfloat16), cfg)
        assert y.shape == (T, cfg.d_model) and y.device.type == "meta"
        assert y.dtype == torch.bfloat16 and aux.shape == ()


# ---------------------------------------------------------------------------
# the two MoE configs through the api
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return request.param, shared_params(request.param)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b", *ARCHS])
def test_config_matches_reference(arch):
    """qwen3-moe-30b-a3b selects the flash kernel (hd = 128, H = 32,
    K = 4) where the reference selects "ref"; dbrx-132b keeps "ref"."""
    cases.check_config(arch, flash=arch == "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("arch,widths,params", [
    ("qwen3-moe-30b-a3b", (48, 2048, 32, 4, 128, 768, 128, 8, 256),
     30_532_110_336),
    ("dbrx-132b", (40, 6144, 48, 8, 128, 10_752, 16, 4, 256),
     131_596_523_520)])
def test_full_config_widths(arch, widths, params):
    cfg = get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.num_experts, cfg.experts_per_token,
            cfg.moe_groups) == widths
    assert cfg.param_count() == params and cfg.dtype == "bfloat16"


def test_init_matches_param_count_and_layout(model):
    arch, params = model
    cases.check_layout(arch, params)
    assert params[1]["layers"]["moe"]["router"].dtype == torch.float32


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(model, S):
    """B = 2: S = 16 makes 32 tokens, grouped (moe_groups 4); 37 makes 74,
    routed globally."""
    cases.check_forward(*model, S)


def test_loss_and_grads_match_jax(model):
    """The loss adds 0.01 x the summed load-balancing terms, as the
    reference's does."""
    cases.check_loss_and_grads(*model)


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(model, S):
    cases.check_prefill_decode(*model, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_and_slot_reuse_match_jax(arch):
    """7 requests on 2 slots (prompts of 4 and 9 tokens: one grouped
    prefill and one global), token for token."""
    params = shared_params(arch)
    requests = cases.random_requests(arch, 7, lengths=(4, 9))
    jout, tout, jeng, teng = cases.serve_both(arch, params, requests,
                                              slots=2, max_seq=48)
    assert tout == jout and len(tout) == 7
    assert teng.stats() == jeng.stats()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_trace_matches_the_counts(arch):
    """One train step of the smoke traced on meta (batch 2 x 32: 64
    tokens, grouped), with flash where its head dim is a flash shape
    (qwen3-moe's 16; dbrx's 8 is none, so its "ref"): flash once a layer
    where selected, two fused add+norms a layer, each with its backward;
    the matrix-product FLOPs those of ``api.train_step_matmul_flops``,
    E x C capacity slots included, and at 31 tokens (routed globally)."""
    cfg = get_config(arch)
    if cfg.hd in HEAD_DIMS:
        cfg = cfg.replace(attn_impl="flash")
    L = cfg.num_layers
    kernels, mm = cases.traced_step(cfg, 2, 32)
    flash = {"flash_attention": L, "flash_attention_bwd": L} \
        if cfg.attn_impl == "flash" else {}
    assert kernels == {**flash, "rmsnorm": 1, "rmsnorm_bwd": 1,
                       "add_rmsnorm": 2 * L, "add_rmsnorm_bwd": 2 * L}
    assert mm == api.train_step_matmul_flops(cfg, 2, 32)
    _, mm_ungrouped = cases.traced_step(cfg, 1, 31)
    assert mm_ungrouped == api.train_step_matmul_flops(cfg, 1, 31)


def test_moe_family_runs_through_the_api():
    """``api.module_for`` takes the moe family (no longer refused)."""
    from repro_torch.models import transformer
    assert api.module_for(get_config(ARCHS[0])) is transformer


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_moe_on_cpu_lowers_the_loss(arch, capsys, tmp_path):
    """``launch.train`` takes the MoE smokes through the registry and the
    fault-tolerant loop (batch 4 x 32: 128 tokens, grouped)."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                              "16", "--batch", "4", "--seq", "32",
                              "--lr", "3e-3",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[loop] step ")]
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_on_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve
    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
