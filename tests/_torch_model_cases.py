"""Checks shared by the model-family parity files (tests/test_torch_
{dense_configs,hybrid,moe,encdec,vlm}.py): one smoke config through the
port's ``repro_torch.models.api`` and the JAX package's
``repro.models.api`` on the same weights (``_torch_parity.shared_params``)
and inputs drawn with numpy, f32 on the CPU.  An enc-dec or VLM batch
also carries its modality stub (``modal``: frames or patches).

Tolerances: ATOL / RTOL 1e-4 on logits, caches and states (f32 model,
sums taken in another order, as tests/test_torch_models.py and
tests/test_torch_mamba.py hold them); the loss within ATOL; gradients
per leaf within LEAF_TOL of the leaf's max |g| (tests/test_torch_grad.py's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import api as japi
from repro.models import get_config as jget_config
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch.core import hlo
from repro_torch.models import api, get_config, list_archs
from repro_torch.serve import Engine, Request
from repro_torch.sharding import umode
from repro_torch.train import optim

from _torch_parity import assert_leaves_close, loss_and_grads

ATOL, RTOL = 1e-4, 1e-4
LEAF_TOL = 1e-4
# fields of the reference's ModelConfig the port leaves out (sharding and
# training knobs, and the unread use_pallas)
NOT_CARRIED = {"remat", "scan_layers", "use_pallas", "seq_shard_activations",
               "fsdp", "microbatches"}


def tokens(arch, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, get_config(arch).vocab_size, (B, S)).astype(np.int32)


def modal(arch, B, seed=11):
    """{"frames": (B, encoder_seq, d)} for an enc-dec arch, {"patches":
    (B, num_patches, d)} for a VLM, {} otherwise: f32 from ``seed``."""
    cfg = get_config(arch)
    key, n = {"encdec": ("frames", cfg.encoder_seq),
              "vlm": ("patches", cfg.num_patches)}.get(cfg.family,
                                                      (None, 0))
    if key is None:
        return {}
    return {key: np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)}


def both(batch):
    """A batch of numpy arrays as (jax arrays, torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def check_config(arch, flash: bool):
    """Every field the port keeps equals the reference's, and the port
    keeps every architecture field; only attn_impl differs, "flash" where
    ``flash`` (the reference's "blocked" or "ref")."""
    mine, ref = get_config(arch), jget_config(arch)
    kept = {f.name for f in dataclasses.fields(mine)} - {"use_kernels"}
    assert kept == {f.name for f in dataclasses.fields(ref)} - NOT_CARRIED
    for name in sorted(kept):
        want = getattr(ref, name)
        if name == "attn_impl" and flash:
            assert mine.attn_impl == "flash" and want in ("blocked", "ref")
            continue
        assert getattr(mine, name) == want, name
    for prop in ("padded_vocab", "hd", "q_dim", "kv_dim", "d_inner",
                 "ssm_heads", "conv_dim"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.param_count() == ref.param_count()
    assert mine.torch_dtype == getattr(torch, ref.dtype)
    assert arch in list_archs()


def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype)
            for k, v in tree.items()}


def check_layout(arch, params):
    """``api.init`` gives the converted reference tree's paths, shapes and
    dtypes, and the config's parameter count."""
    cfg = get_config(arch)
    mine = api.init(0, cfg, device="cpu")
    assert api.param_count(mine) == cfg.param_count()
    assert shapes(mine) == shapes(params[1])


def check_forward(arch, params, S, B=2):
    """Logits (and aux) of S tokens, after the modality stub's rows for a
    VLM."""
    jp, tp = params
    jb, tb = both({"tokens": tokens(arch, B, S), **modal(arch, B)})
    jcfg = jget_config(arch)
    want, jaux = jax.jit(lambda p, b: japi.forward(p, jcfg, b))(jp, jb)
    got, aux = api.forward(tp, get_config(arch), tb)
    extra = get_config(arch).num_patches if "patches" in tb else 0
    assert got.shape == (B, extra + S, get_config(arch).padded_vocab)
    close(got, want)
    assert abs(float(aux) - float(jaux)) < ATOL


def check_loss_and_grads(arch, params, S=24, B=2):
    """The masked loss and every param's gradient against jax.grad."""
    jp, tp = params
    toks = tokens(arch, B, S, seed=3)
    tgt = np.roll(toks, -1, axis=1)
    mask = (np.arange(S) < S - 4).astype(np.float32)[None].repeat(B, 0)
    jcfg = jget_config(arch)
    jb, tb = both({"tokens": toks, "targets": tgt, "mask": mask,
                   **modal(arch, B, seed=12)})
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss(p, jcfg, jb)))(jp)
    got, grads = loss_and_grads(tp, get_config(arch), tb)
    assert abs(float(got) - float(want)) < ATOL
    assert_leaves_close(grads, jgrads, LEAF_TOL)


def check_prefill_decode(arch, params, S, B=2, max_seq=48, steps=4):
    """Prefill into a cache of ``max_seq``, then greedy decode steps:
    logits and every cache leaf against the reference's."""
    jp, tp = params
    cfg, jcfg = get_config(arch), jget_config(arch)
    jb, tb = both({"tokens": tokens(arch, B, S, seed=4),
                   **modal(arch, B, seed=13)})
    jc = japi.init_cache(jcfg, B, max_seq)
    want, jc = jax.jit(lambda p, c, b: japi.prefill(p, jcfg, c, b))(
        jp, jc, jb)
    tc = api.init_cache(cfg, B, max_seq, device="cpu")
    got, tc = api.prefill(tp, cfg, tc, tb)
    close(got, want)
    assert sorted(tc) == sorted(jc)
    assert int(tc["pos"]) == int(jc["pos"])
    for key in jc:
        close(tc[key], jc[key])
    decode = jax.jit(lambda p, c, t: japi.decode_step(p, jcfg, c, t))
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(want, axis=-1), np.int32)
        want, jc = decode(jp, jc, jnp.asarray(nxt))
        got, tc = api.decode_step(tp, cfg, tc, torch.tensor(nxt).long())
        close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == \
        S + steps + (cfg.num_patches if "patches" in tb else 0)
    for key in jc:
        close(tc[key], jc[key])


def serve_both(arch, params, requests, **kw):
    """The same requests through the JAX Engine and the port's, drained;
    returns (jax outputs, port outputs, jax engine, port engine)."""
    jp, tp = params
    engines = (JEngine(jget_config(arch), jp, **kw),
               Engine(get_config(arch), tp, device="cpu", **kw))
    outs = []
    for eng, cls in zip(engines, (JRequest, Request)):
        for uid, prompt, n in requests:
            eng.submit(cls(uid=uid, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=n))
        outs.append({r.uid: r.output for r in eng.run_until_drained()})
    return (*outs, *engines)


def random_requests(arch, n, seed=0, lengths=(3, 9), max_new=7):
    """n requests of random tokens: prompts of the given lengths (the JAX
    Engine compiles its prefill once per length), 1..max_new-1 new
    tokens."""
    rng = np.random.default_rng(seed)
    vocab = get_config(arch).vocab_size
    return [(i, rng.integers(0, vocab, int(rng.choice(lengths))),
             int(rng.integers(1, max_new))) for i in range(n)]


def traced_step(cfg, B, S):
    """One ``umode.make_train_step`` step of ``cfg`` traced on meta, at B x
    S tokens (and an enc-dec's or VLM's modality stub): (its kernel ops,
    its matrix-product FLOPs)."""
    state = optim.init_state(api.init(0, cfg, device="meta"))
    batch = {k: torch.zeros((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    stub = {"encdec": ("frames", cfg.encoder_seq),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if stub is not None:
        batch[stub[0]] = torch.zeros((B, stub[1], cfg.d_model),
                                     device="meta")
    cost = hlo.analyze(umode.make_train_step(cfg, optim.OptConfig()), state,
                       batch)
    return hlo.kernel_ops(cost.trace), hlo.matmul_flops(cost)
