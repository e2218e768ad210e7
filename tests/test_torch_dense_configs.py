"""The dense configs the port added after qwen2-1.5b (qwen1.5-4b,
internlm2-20b, qwen1.5-110b) vs the JAX reference: configs field for
field, and each smoke's forward, loss, gradients, prefill and decode
steps (f32, CPU); the smoke train steps traced on meta.  Tolerances in
tests/_torch_model_cases.py."""
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import _torch_model_cases as cases  # noqa: E402
from _torch_parity import shared_params  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402

FULL = ["qwen1.5-4b", "internlm2-20b", "qwen1.5-110b"]
SMOKES = [f"{a}-smoke" for a in FULL]


@pytest.fixture(scope="module", params=SMOKES)
def model(request):
    return request.param, shared_params(request.param)


@pytest.mark.parametrize("arch", FULL + SMOKES)
def test_config_matches_reference(arch):
    """The full configs select the flash kernel (hd = 128) where the
    reference selects "blocked" or "ref"; the smokes keep "ref"."""
    cases.check_config(arch, flash=arch in FULL)


@pytest.mark.parametrize("arch,widths,params", [
    ("qwen1.5-4b", (40, 2560, 20, 20, 128, 6912, 151_936), 3_950_369_280),
    ("internlm2-20b", (48, 6144, 48, 8, 128, 16_384, 92_544), 19_861_149_696),
    ("qwen1.5-110b", (80, 8192, 64, 8, 128, 49_152, 152_064),
     111_209_914_368)])
def test_full_config_widths(arch, widths, params):
    cfg = get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size) == widths
    assert cfg.param_count() == params and cfg.dtype == "bfloat16"


def test_init_matches_param_count_and_layout(model):
    arch, params = model
    cases.check_layout(arch, params)


@pytest.mark.parametrize("S", [16, 37])
def test_forward_matches_jax(model, S):
    cases.check_forward(*model, S)


def test_loss_and_grads_match_jax(model):
    cases.check_loss_and_grads(*model)


@pytest.mark.parametrize("S", [16, 37])
def test_prefill_cache_and_decode_match_jax(model, S):
    cases.check_prefill_decode(*model, S)


@pytest.mark.parametrize("arch", SMOKES)
def test_flash_impl_matches_reference_forward(arch):
    """The smokes with attn_impl="flash" (the kernel wrapper, its plain
    version on the CPU) compute the reference's "ref" function."""
    cfg = get_config(arch).replace(attn_impl="flash")
    toks = torch.from_numpy(cases.tokens(arch, 1, 21)).long()
    params = api.init(0, cfg, device="cpu")
    got, _ = api.forward(params, cfg, {"tokens": toks})
    want, _ = api.forward(params, cfg.replace(attn_impl="ref"),
                          {"tokens": toks})
    cases.close(got, want.numpy())


@pytest.mark.parametrize("arch", SMOKES)
def test_train_step_trace_matches_the_counts(arch):
    """One train step of the smoke traced on meta, with the materialised
    attention and, where its head dim is a flash shape (qwen1.5-4b's 16;
    the others' 8 is none), with flash: a flash launch a layer and two
    fused add+norms (the first norm plain), each with its backward, and
    the matrix-product FLOPs of ``api.train_step_matmul_flops``, the
    count chip_smoke.py holds the full configs to."""
    cfg = get_config(arch)
    L = cfg.num_layers
    for impl in ("ref", "flash")[:1 + (cfg.hd in HEAD_DIMS)]:
        c = cfg.replace(attn_impl=impl)
        kernels, mm = cases.traced_step(c, 2, 32)
        flash = {"flash_attention": L, "flash_attention_bwd": L} \
            if impl == "flash" else {}
        assert kernels == {**flash, "rmsnorm": 1, "rmsnorm_bwd": 1,
                           "add_rmsnorm": 2 * L, "add_rmsnorm_bwd": 2 * L}
        assert mm == api.train_step_matmul_flops(c, 2, 32)
