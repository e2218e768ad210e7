"""Shared neural building blocks (port of ``repro/models/layers.py``).

Functional, as in the reference: params are plain dicts of tensors with
the reference's keys, per-layer params are stacked on a leading layer
axis, and every module is ``init_*(gen, cfg, device) -> params`` plus
``apply(params, x, ...) -> y``.  Randomness comes from an explicit
``torch.Generator`` on the target device.

``rms_norm`` (and its fused forms ``add_rms_norm`` and
``gated_rms_norm``) and ``attn_impl="flash"`` go through the hand-written
kernels (``repro_torch.kernels.ops``) when ``cfg.use_kernels``, else
through their plain versions.  The projections, the MLPs (SwiGLU and
the enc-dec's gelu), the sinusoidal positions, decode self-attention and
``unembed`` are plain tensor code, as the reference leaves them to XLA.
"""
from __future__ import annotations

import math
import typing

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

Params = typing.Dict[str, typing.Any]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a generator on the ``meta`` device, which has none:
    draws there allocate nothing and make no values (``draws``)."""
    device = torch.device("meta")


def generator(seed, device: torch.device) -> torch.Generator:
    """``seed`` (an int, or a ``torch.Generator`` already on ``device``)
    as a generator on ``device``; on ``meta`` a ``MetaGenerator``."""
    if device.type == "meta":
        return MetaGenerator()
    if isinstance(seed, torch.Generator):
        if seed.device != device:
            raise ValueError(f"generator on {seed.device}, params asked "
                             f"for on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def layer_slice(tree, i: int):
    """Layer ``i``'s slice of a param tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def layer_slices(tree, n: int):
    """``[layer_slice(tree, i) for i in range(n)]`` of a tree stacked on a
    leading axis of length n, cut with one ``unbind`` per leaf.  For a
    backward this matters: autograd stacks the n slices' gradients into
    the leaf's gradient once, where n separate indexings would each add a
    zero-padded full-size gradient (n^2 layers' worth of bytes)."""
    if isinstance(tree, dict):
        per_key = {k: layer_slices(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    if tree.shape[0] != n:
        raise ValueError(f"a stacked leaf of shape {tuple(tree.shape)} has "
                         f"no leading axis of {n} layers")
    return tree.unbind(0)


def draws(gen) -> typing.Optional[torch.Generator]:
    """The ``generator=`` argument of a draw from ``gen``."""
    return None if isinstance(gen, MetaGenerator) else gen


# a leaf whose f32 draw would take more bytes than this is drawn one
# slice of its leading axis at a time, into the output's dtype: a stacked
# expert or MLP leaf of a large model (qwen3-moe-30b-a3b's 38.7 GB of f32
# for one 19.3 GB bf16 leaf) would not fit the card otherwise.  Smaller
# leaves are drawn whole, so their values are those of earlier ports.
WHOLE_DRAW_BYTES = 1 << 32


def dense_init(gen: torch.Generator, shape, dtype, scale: float = None):
    """Truncated-normal (+-2 sigma) fan-in init; stacked shapes keep the
    per-slice fan-in (``shape[-2]``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)

    def draw(shape_):
        w = torch.empty(shape_, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=draws(gen))
        return (w * scale).to(dtype)
    if gen.device.type == "meta" or 4 * math.prod(shape) <= WHOLE_DRAW_BYTES:
        return draw(shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for part in out:
        part.copy_(draw(part.shape))
    return out


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=draws(gen), dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# normalisation
# --------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6, use_kernel: bool = True):
    """x * rsqrt(mean(x^2) + eps) * weight in f32 math, output in x's
    dtype: the rmsnorm kernel (which takes rows in contiguous memory, so
    a strided view such as ``h[:, -1:]`` is copied first), or its plain
    version."""
    if use_kernel:
        return kops.rmsnorm(x.contiguous(), weight, eps)
    return kref.rmsnorm_ref(x, weight, eps)


def add_rms_norm(h, r, weight, eps: float = 1e-6, use_kernel: bool = True):
    """A residual add and the pre-norm after it: (h + r, rms_norm(h + r)),
    one launch of the fused kernel (h + r is written out of place); with
    r None, (h, rms_norm(h)).  Callers defer each block's residual add to
    the next norm, so no add runs on its own."""
    if r is None:
        return h, rms_norm(h, weight, eps, use_kernel)
    if use_kernel:
        return kops.add_rmsnorm(h.contiguous(), r.contiguous(), weight, eps)
    return kref.add_rmsnorm_ref(h, r, weight, eps)


def gated_rms_norm(x, z, weight, eps: float = 1e-6, use_kernel: bool = True):
    """rms_norm(x * silu(z)) (Mamba2's gated norm), one launch of the fused
    kernel, or its plain version."""
    if use_kernel:
        return kops.gated_rmsnorm(x.contiguous(), z.contiguous(), weight, eps)
    return kref.gated_rmsnorm_ref(x, z, weight, eps)


# --------------------------------------------------------------------------
# rotary position embedding (rotate-half convention)
# --------------------------------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,S) int -> (...,S, head_dim//2) angles."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    return positions[..., None].float() * inv_freq


def apply_rope(x, angles):
    """x: (B,S,H,hd); angles: (S,hd/2) or (B,S,hd/2)."""
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d_model: int, dtype, device="cpu",
                   positions=None):
    """(seq_len, d_model) sinusoidal position table in ``dtype``: angle
    pos / 10000^(2i / d_model) in f32, sin at even columns and cos at odd
    ones (``repro/models/layers.py:79``).  With ``positions`` (an int
    tensor of any length) only those rows of the table, computed the
    same way."""
    if positions is None:
        positions = torch.arange(seq_len, device=device)
    pos = positions.to(torch.float32)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=pos.device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe.reshape(pos.shape[0], d_model).to(dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, n_layers: int) -> Params:
    """Weights of ``n_layers`` attention blocks, stacked on axis 0."""
    d, dt, n = cfg.d_model, cfg.torch_dtype, n_layers
    p = {
        "wq": dense_init(gen, (n, d, cfg.q_dim), dt),
        "wk": dense_init(gen, (n, d, cfg.kv_dim), dt),
        "wv": dense_init(gen, (n, d, cfg.kv_dim), dt),
        "wo": dense_init(gen, (n, cfg.q_dim, d), dt,
                         scale=1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                            ("bv", cfg.kv_dim)):
            p[name] = torch.zeros((n, width), dtype=dt, device=gen.device)
    return p


def qkv(p: Params, x, cfg, positions=None):
    """Project + (optionally) rope. x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, cfg.hd)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.hd)
    if positions is not None:
        ang = rope_angles(positions, cfg.hd, cfg.rope_theta)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def attention_core(q, k, v, mask=None, causal: bool = False,
                   impl: str = "ref", use_kernel: bool = True):
    """GQA attention. q: (B,S,H,hd); k/v: (B,T,K,hd); H % K == 0.

    mask: broadcastable to (B,1,1,S,T) boolean (True = attend) or None.
    impl: "ref" (materialized scores) or "flash" (the flash-attention
    kernel, or its plain version when not ``use_kernel``); "flash" is
    taken for every call without a mask: causal self-attention, where
    S == T, and non-causal attention at any S and T (an encoder's, and
    cross-attention).  The reference routes only the causal calls to its
    kernel (``repro/models/layers.py:182``), though that kernel takes
    non-causal ones too: the function is the same.
    """
    if impl not in ("ref", "flash"):
        raise ValueError(f"attn_impl {impl!r}: the port has 'ref' and "
                         f"'flash'")
    if impl == "flash" and mask is None:
        if use_kernel:
            return kops.flash_attention(q, k, v, causal=causal)
        return kref.flash_attention_ref(q, k, v, causal=causal)
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * scale
    if causal:
        cm = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        scores = scores.masked_fill(~cm, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def attention_block(p: Params, x, cfg, positions=None, causal=True,
                    kv_cache=None, cache_pos=None, kv_override=None):
    """Full attention block: qkv -> core -> output proj.

    Train / prefill: kv_cache None -> self attention over x.
    Decode: kv_cache = (k_cache, v_cache) of static length T; the new
    tokens' k/v are written at ``cache_pos`` (scalar or (B,) per slot)
    and attention masks t <= pos.  The cache is updated IN PLACE (the
    reference returns a new one), which saves copying it every step.
    Cross-attention: kv_override = (k, v) precomputed from the encoder;
    only q is projected, and the core is non-causal.
    Returns (out, (k, v)): the new k/v, or the updated cache; None for
    cross-attention.
    """
    B, S, _ = x.shape
    if kv_override is not None:
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(B, S, cfg.num_heads, cfg.hd)
        if positions is not None:
            q = apply_rope(q, rope_angles(positions, cfg.hd, cfg.rope_theta))
        k, v = kv_override
        out = attention_core(q, k, v, causal=False, impl=cfg.attn_impl,
                             use_kernel=cfg.use_kernels)
        return out.reshape(B, S, -1) @ p["wo"], None
    q, k, v = qkv(p, x, cfg, positions)
    if kv_cache is None:
        out = attention_core(q, k, v, causal=causal, impl=cfg.attn_impl,
                             use_kernel=cfg.use_kernels)
        return out.reshape(B, S, -1) @ p["wo"], (k, v)

    kc, vc = kv_cache                       # (B, T, K, hd) static T
    T = kc.shape[1]
    pos = torch.as_tensor(cache_pos, device=x.device).expand(B)
    # lax.dynamic_update_slice clamps the start to [0, T - S]: an idle
    # slot whose position ran past the cache rewrites its last rows
    # instead of indexing out of range.  The mask keeps the raw position.
    start = pos.clamp(0, T - S)
    rows = torch.arange(B, device=x.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=x.device)
    kc[rows, cols] = k.to(kc.dtype)
    vc[rows, cols] = v.to(vc.dtype)
    valid = (torch.arange(T, device=x.device)[None, :]
             <= (pos[:, None] + S - 1))[:, None, None, None, :]
    out = attention_core(q, kc, vc, mask=valid, impl="ref")
    return out.reshape(B, S, -1) @ p["wo"], (kc, vc)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def unstack(tree):
    """The one layer of a tree stacked on a leading axis of length 1 (an
    ``init_*(gen, cfg, 1)``), as unstacked leaves."""
    if isinstance(tree, dict):
        return {k: unstack(v) for k, v in tree.items()}
    return tree.squeeze(0)


def init_swiglu(gen: torch.Generator, cfg, n_layers: int) -> Params:
    d, f, dt, n = cfg.d_model, cfg.d_ff, cfg.torch_dtype, n_layers
    return {"wg": dense_init(gen, (n, d, f), dt),
            "wu": dense_init(gen, (n, d, f), dt),
            "wd": dense_init(gen, (n, f, d), dt)}


def swiglu(p: Params, x):
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def init_gelu_mlp(gen: torch.Generator, cfg, n_layers: int) -> Params:
    d, f, dt, n = cfg.d_model, cfg.d_ff, cfg.torch_dtype, n_layers
    return {"w1": dense_init(gen, (n, d, f), dt),
            "w2": dense_init(gen, (n, f, d), dt)}


def gelu_mlp(p: Params, x):
    """The enc-dec's two-matrix MLP.  ``jax.nn.gelu`` defaults to the tanh
    approximation, torch's gelu to erf: the reference's is the tanh one."""
    return torch.nn.functional.gelu(x @ p["w1"], approximate="tanh") \
        @ p["w2"]


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg) -> Params:
    dt = cfg.torch_dtype
    V = cfg.padded_vocab
    p = {"embed": embed_init(gen, (V, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, V), dt)
    return p


def embed(p: Params, tokens):
    return p["embed"][tokens]


def unembed(p: Params, h, cfg):
    """Project to (padded) vocab logits; padded columns set to -1e30 so
    softmax/argmax semantics are exactly the unpadded model's."""
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (h @ w).float()
    Vp = logits.shape[-1]
    if Vp != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def cross_entropy(logits, targets, mask=None):
    """logits (B,S,V) f32, targets (B,S) int -> scalar mean nll."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)
