"""Vectorized analytic collective pricing: thousands of points per call.

The closed-form ring / hierarchical / bisection / cross-pod formulas in
:class:`repro.core.topology.Topology` price one collective per Python
call -- fine on the live event timeline, hopeless for a design-space
sweep that wants to price (config x traffic) grids with thousands of
points.  This module mirrors those formulas as numpy ``float64`` array
kernels: every expression tree is **identical** to the scalar path
(same operands, same association order), so the vectorized results are
*bit-equal* to ``Topology.price`` -- not merely close.  That exactness
is load-bearing: the scalar formulas are the parity oracle the event
fabric is validated against, and ``tests/test_pricing.py`` asserts
``==`` (no tolerance) across the full kind x class x payload grid.

Two consumers:

* the ``analytic`` fabric backend batches homogeneous same-timestep
  pricings through :func:`price_collectives` instead of evaluating one
  formula per Python event handler (``repro.fabric.analytic``);
* the sweep driver (``tools/sweep.py``) and the throughput benchmark
  (``benchmarks/sweep_throughput.py``) price whole scenario grids with
  :func:`price` over broadcast :class:`FabricParams` arrays.

All kernels are plain broadcasting ops (no indexing tricks), so they
also run unchanged under ``jax.numpy`` for an accelerator-resident
sweep -- but the supported, parity-tested dtype is numpy ``float64``
(jax defaults to ``float32``, which would break bit-equality).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np

# Collective kinds and group classes, in a fixed code order shared by
# every consumer.  ``classify_group``'s "self" (singleton) class is not
# listed: singleton groups price to 0.0 before classification matters.
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
CLASSES = ("ring_x", "ring_y", "block_2d", "cross_pod")

KIND_CODES = {k: i for i, k in enumerate(KINDS)}
CLASS_CODES = {c: i for i, c in enumerate(CLASSES)}
CLASS_CODES["self"] = 0          # priced 0.0 via the n<=1 mask anyway

_AR, _AG, _RS, _A2A, _CP = range(5)
_RING_X, _RING_Y, _BLOCK_2D, _CROSS_POD = range(4)


def encode_kinds(kinds) -> np.ndarray:
    """Kind names (str or sequence) -> int codes; raises on unknowns."""
    if isinstance(kinds, str):
        return np.asarray(KIND_CODES[kinds])
    try:
        return np.asarray([KIND_CODES[k] for k in kinds])
    except KeyError as e:
        raise ValueError(f"unknown collective kind {e.args[0]!r}; "
                         f"known: {KINDS}") from None


def encode_classes(classes) -> np.ndarray:
    """Group-class names (str or sequence) -> int codes."""
    if isinstance(classes, str):
        return np.asarray(CLASS_CODES[classes])
    try:
        return np.asarray([CLASS_CODES[c] for c in classes])
    except KeyError as e:
        raise ValueError(f"unknown group class {e.args[0]!r}; "
                         f"known: {CLASSES}") from None


@dataclasses.dataclass(frozen=True)
class FabricParams:
    """Broadcastable spec parameters for one -- or many -- machines.

    Each field is a scalar or a numpy array; all fields must broadcast
    against each other and against the traffic arrays handed to
    :func:`price`.  ``from_spec`` gives plain scalars (one machine);
    ``stack`` gives shape-``(k,)`` arrays over ``k`` machine configs --
    reshape (e.g. ``params.reshape((k, 1))``) to sweep configs on one
    axis and traffic points on another.
    """

    ici_bw: typing.Any          # bytes/s per ICI link per direction
    hop_s: typing.Any           # ICI per-hop latency, seconds
    dcn_bw: typing.Any          # aggregate DCN bytes/s per pod
    dcn_s: typing.Any           # cross-pod one-way latency, seconds
    bisect_bw: typing.Any       # pod bisection bytes/s
    X: typing.Any               # pod torus x dimension (int)
    Y: typing.Any               # pod torus y dimension (int)
    pods: typing.Any            # number of pods (int)

    @classmethod
    def from_spec(cls, spec) -> "FabricParams":
        c = spec.chip
        return cls(ici_bw=c.ici_link_bandwidth, hop_s=c.ici_hop_latency_s,
                   dcn_bw=spec.dcn_bandwidth_per_pod, dcn_s=c.dcn_latency_s,
                   bisect_bw=spec.bisection_bandwidth_per_pod,
                   X=spec.pod_shape[1], Y=spec.pod_shape[0],
                   pods=spec.num_pods)

    @classmethod
    def stack(cls, specs) -> "FabricParams":
        rows = [cls.from_spec(s) for s in specs]
        return cls(*(np.asarray([getattr(r, f.name) for r in rows])
                     for f in dataclasses.fields(cls)))

    def reshape(self, shape) -> "FabricParams":
        return FabricParams(*(np.reshape(getattr(self, f.name), shape)
                              for f in dataclasses.fields(FabricParams)))


# -- formula kernels (each mirrors its Topology._* scalar twin EXACTLY) ------

def ring_time(B, n, phases, p: FabricParams):
    """Mirror of ``Topology._ring_time`` (bidirectional ring)."""
    bw = 2 * p.ici_bw
    steps = phases * (n - 1)
    return phases * (n - 1) / n * B / bw + steps * p.hop_s


def block2d_time(B, n, phases, p: FabricParams):
    """Mirror of ``Topology._block2d_time`` (x rings then y rings)."""
    nx = np.minimum(p.X, n)
    ny = np.maximum(1, n // nx)
    t = ring_time(B, nx, phases, p)
    return np.where(ny > 1, t + ring_time(B / nx, ny, phases, p), t)


def alltoall_ring_time(B, n, p: FabricParams):
    """Mirror of ``Topology._alltoall_ring_time``."""
    return (B * (n - 1) / 8) / p.ici_bw + (n / 2) * p.hop_s


def alltoall_block_time(B, n, p: FabricParams):
    """Mirror of ``Topology._alltoall_block_time`` (bisection-limited)."""
    cross = n * B / 2
    return cross / p.bisect_bw + (p.X / 2 + p.Y / 2) * p.hop_s


def cross_pod_time(kind, B, n, n_groups, p: FabricParams):
    """Mirror of ``Topology._cross_pod_time``.

    ``n`` is the member count of one group, ``n_groups`` the number of
    concurrent groups sharing the pods' DCN bandwidth (the live fabric
    path prices one group per coordinator call, i.e. ``n_groups=1``).
    """
    pods = p.pods
    per_pod = np.maximum(1, n // pods)
    eff = np.where(kind == _AR, 2 * (pods - 1) / pods, (pods - 1) / pods)
    multi = per_pod > 1
    t = np.where(multi, block2d_time(B, per_pod, 1.0, p), 0.0)
    Bx = np.where(multi, B / per_pod, B)
    # scalar path: t += dcn_bytes / dcn_bw + dcn_latency  (one RHS, so
    # the association is t + ((bytes/bw) + lat) -- mirror it exactly)
    t = t + (n_groups * Bx * eff / p.dcn_bw + p.dcn_s)
    closing = multi & ((kind == _AR) | (kind == _AG))
    return np.where(closing,
                    t + block2d_time(Bx * per_pod, per_pod, 1.0, p), t)


def price(kind, cls, B, n, params: FabricParams, n_groups=1) -> np.ndarray:
    """Price a whole (config x traffic) grid in a handful of array ops.

    ``kind`` / ``cls`` -- kind and group-class names (one str each) or
    int code arrays (:func:`encode_kinds` / :func:`encode_classes`);
    ``B`` -- float payload bytes per participant (the same B convention
    as ``Topology.collective_time_s``); ``n`` -- int group member
    counts; ``params`` -- broadcastable :class:`FabricParams`.  All
    five broadcast together; the result is the broadcast-shaped
    ``float64`` array of seconds, element-wise bit-equal to
    ``Topology.price`` on the matching scalar inputs.
    """
    kind = encode_kinds(kind) if isinstance(kind, str) else np.asarray(kind)
    cls = encode_classes(cls) if isinstance(cls, str) else np.asarray(cls)
    B = np.asarray(B, dtype=np.float64)
    n = np.asarray(n)
    ng = np.asarray(n_groups)
    pf = [np.asarray(getattr(params, f.name))
          for f in dataclasses.fields(FabricParams)]
    shape = np.broadcast_shapes(kind.shape, cls.shape, B.shape, n.shape,
                                ng.shape, *(a.shape for a in pf))

    # Every (kind, class) combination evaluates its formula only on its
    # own lanes (boolean mask -> gather, formula, scatter).  This is a
    # pure optimization over full-width branch evaluation + np.select:
    # each lane still runs the exact scalar expression tree, so
    # bit-equality with ``Topology.price`` is untouched, but a mixed
    # grid does ~1/5 of the element work.
    def flat(a):
        return a if a.ndim == 0 else np.broadcast_to(a, shape).reshape(-1)

    kindf, clsf, Bf, nf, ngf = (flat(a) for a in (kind, cls, B, n, ng))
    pflat = [flat(a) for a in pf]

    def at(a, idx):
        return a if a.ndim == 0 else a[idx]

    out = np.zeros(int(np.prod(shape, dtype=np.int64)))

    def fill(mask, fn):
        idx = np.flatnonzero(mask)
        if idx.size:
            p = FabricParams(*(at(a, idx) for a in pflat))
            out[idx] = fn(at(Bf, idx), at(nf, idx), idx, p)

    live = nf > 1                       # n<=1 lanes stay 0.0 (never priced)
    cross = clsf == _CROSS_POD
    ringm = live & ~cross & (clsf <= _RING_Y)
    blockm = live & ~cross & (clsf == _BLOCK_2D)
    agrs = (kindf == _AG) | (kindf == _RS)
    fill(ringm & (kindf == _AR), lambda b, m, i, p: ring_time(b, m, 2.0, p))
    fill(blockm & (kindf == _AR),
         lambda b, m, i, p: block2d_time(b, m, 2.0, p))
    fill(ringm & agrs, lambda b, m, i, p: ring_time(b, m, 1.0, p))
    fill(blockm & agrs, lambda b, m, i, p: block2d_time(b, m, 1.0, p))
    fill(ringm & (kindf == _A2A),
         lambda b, m, i, p: alltoall_ring_time(b, m, p))
    fill(blockm & (kindf == _A2A),
         lambda b, m, i, p: alltoall_block_time(b, m, p))
    fill(live & ~cross & (kindf == _CP),
         lambda b, m, i, p: b / p.ici_bw + p.hop_s)
    fill(live & cross,
         lambda b, m, i, p: cross_pod_time(at(kindf, i), b, m,
                                           at(ngf, i), p))
    return out.reshape(shape)


def classify_cached(topology, memo: dict, group: tuple) -> int:
    """Class code of one replica group, memoized by group tuple -- the
    per-group classification is pure Python coordinate walking and
    dominates batched pricing without this."""
    code = memo.get(group)
    if code is None:
        code = memo[group] = CLASS_CODES[topology.classify_group(list(group))]
    return code


def price_collectives(topology, items, memo: dict = None) -> np.ndarray:
    """Vector-price a batch of per-group collectives on one machine.

    ``items``: sequence of ``(kind, nbytes, group)`` with ``group`` a
    tuple of member ids -- exactly the payload of one coordinator
    ``start`` request each, so ``n_groups=1`` like the scalar live path
    (``Topology.price(kind, nbytes, [group])``).  Returns seconds, one
    per item, bit-equal to that scalar call.
    """
    if memo is None:
        memo = {}
    k = len(items)
    kinds = np.fromiter((KIND_CODES[kind] for kind, _, _ in items),
                        dtype=np.int64, count=k)
    B = np.fromiter((nbytes for _, nbytes, _ in items),
                    dtype=np.float64, count=k)
    n = np.fromiter((len(group) for _, _, group in items),
                    dtype=np.int64, count=k)
    cls = np.fromiter((classify_cached(topology, memo, tuple(group))
                       for _, _, group in items), dtype=np.int64, count=k)
    return price(kinds, cls, B, n, FabricParams.from_spec(topology.spec))
