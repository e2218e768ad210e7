"""Multi-pod TPU topology: intra-pod 2-D ICI torus + inter-pod DCN.

This is the adaptation of the paper's interconnect model (PCIe bus +
RDMA engines between GPUs) to the TPU world:

* within a pod, chips form a 2-D torus of ICI links (4 links/chip,
  ~50 GB/s per direction per link);
* pods are connected over DCN with an aggregate per-pod bandwidth.

Device numbering convention (shared with ``launch/mesh.py``): device
``i`` lives in pod ``i // chips_per_pod``; within the pod, ``x = k % X``,
``y = k // X`` for ``k = i % chips_per_pod`` with pod shape ``(Y, X)``.
The mesh axes map as: "model" -> x rings (contiguous device ids),
"data" -> y rings, "pod" -> DCN.

Collective cost models are analytic (ring / hierarchical / bisection
formulas), validated against hand-computed micro-benchmarks in
``tests/test_sim_topology.py`` -- the Fig. 6-analog "parameter at a
time" fits.  The simulator consumes them through the pluggable
``repro.fabric`` registry: the ``analytic`` backend prices collectives
with these formulas directly (O(1) events each), while the ``event``
backend replays the same decompositions as per-hop transfer events on
link components and uses this module only for geometry
(:meth:`Topology.coords` / :meth:`Topology.classify_group`).  These
formulas remain the parity oracle the event backend is tested against
(``tests/test_fabric.py``).
"""
from __future__ import annotations

import dataclasses
import math
import re
import typing
import warnings

import numpy as np

from .hw import SystemSpec


# --------------------------------------------------------------------------
# replica_groups parsing
# --------------------------------------------------------------------------

_IOTA_RE = re.compile(
    r"replica_groups=\[\s*(\d+)\s*,\s*(\d+)\s*\]"
    r"<=\[([\d,\s]+)\](?:T\(([\d,\s]+)\))?")
_LIST_RE = re.compile(r"replica_groups=\{\{([\d,{}\s]+)\}\}")
_EMPTY_RE = re.compile(r"replica_groups=\{\s*\}")


# Ops already warned about for the `replica_groups={}` shorthand; one
# warning per op name per run, so a sweep over foreign HLO says which
# collectives it priced as free without drowning the log.
_warned_empty_groups: set = set()


def parse_replica_groups(attr: str,
                         op: str = None) -> typing.List[typing.List[int]]:
    """Parse HLO ``replica_groups=`` in both iota and explicit-list forms.

    Iota form: ``[G,S]<=[d0,d1,...]T(p0,p1,...)`` -- reshape iota(prod d)
    to [d...], transpose by perm, flatten, split into G groups of S.

    Returns ``[]`` when the attribute string carries no replica groups at
    all: a collective-permute's ``source_target_pairs`` (``hlo.py`` has
    its own fallback for those), or XLA's ``replica_groups={}``
    "one flat group" shorthand -- the latter is a known limitation: we
    cannot recover the device count here, so such a collective carries
    no groups and is treated as free downstream (the SPMD modules we
    analyze always emit explicit groups).  Because "free" silently
    flatters sweeps over foreign HLO, hitting the shorthand emits a
    once-per-run :class:`UserWarning` naming the op (pass ``op=`` for an
    attributable message).  Both forms are anchored to
    ``replica_groups=`` -- an earlier unanchored parse happily consumed
    ``source_target_pairs`` brace lists, silently defeating the permute
    fallback in ``hlo.py``.  A present but malformed ``replica_groups=``
    raises :class:`ValueError` -- a parse that silently dropped groups
    would misprice every collective downstream.
    """
    m = _IOTA_RE.search(attr)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        flat = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            perm = [int(p) for p in m.group(4).split(",")]
            if sorted(perm) != list(range(len(dims))):
                raise ValueError(
                    f"replica_groups transpose {perm} is not a permutation "
                    f"of {len(dims)} iota dims: {attr!r}")
            flat = flat.transpose(perm)
        flat = flat.reshape(-1)
        if flat.size != g * s:
            raise ValueError(
                f"iota replica_groups promise {g}x{s}={g * s} ids but the "
                f"iota dims {dims} yield {flat.size}: {attr!r}")
        return [flat[i * s:(i + 1) * s].tolist() for i in range(g)]
    m = _LIST_RE.search(attr)
    if m:
        groups = []
        for grp in re.findall(r"\{([\d,\s]+)\}", m.group(0)):
            groups.append([int(x) for x in grp.split(",") if x.strip()])
        if not groups:
            raise ValueError(f"malformed replica_groups list: {attr!r}")
        return groups
    if "replica_groups" in attr:
        if not _EMPTY_RE.search(attr):
            raise ValueError(f"malformed replica_groups attribute: {attr!r}")
        label = op or "<unnamed collective>"
        if label not in _warned_empty_groups:
            _warned_empty_groups.add(label)
            warnings.warn(
                f"replica_groups={{}} on {label}: XLA's one-flat-group "
                "shorthand carries no device count, so this collective "
                "will be priced as FREE (known limitation; emit explicit "
                "replica groups to price it)", UserWarning, stacklevel=2)
    return []


# --------------------------------------------------------------------------
# Topology + coordinates
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Link:
    """A directed ICI link. Not an engine component: byte counters only
    (per-packet events would be prohibitive; occupancy is analytic)."""
    name: str
    bandwidth: float
    bytes_total: float = 0.0


class Topology:
    def __init__(self, spec: SystemSpec) -> None:
        self.spec = spec
        self.Y, self.X = spec.pod_shape
        self.links: dict = {}
        for pod in range(spec.num_pods):
            for y in range(self.Y):
                for x in range(self.X):
                    for d in ("+x", "-x", "+y", "-y"):
                        n = f"pod{pod}.ici[{y},{x}]{d}"
                        self.links[n] = Link(n, spec.chip.ici_link_bandwidth)
        self.dcn = [Link(f"pod{p}.dcn", spec.dcn_bandwidth_per_pod)
                    for p in range(spec.num_pods)]

    def coords(self, device: int) -> tuple:
        cpp = self.spec.chips_per_pod
        pod, k = divmod(device, cpp)
        return pod, k // self.X, k % self.X

    def classify_group(self, group: typing.List[int]) -> str:
        """Classify a replica group by the fabric it exercises."""
        coords = [self.coords(d) for d in group]
        pods = {c[0] for c in coords}
        if len(pods) > 1:
            return "cross_pod"
        ys = {c[1] for c in coords}
        xs = {c[2] for c in coords}
        if len(group) == 1:
            return "self"
        if len(ys) == 1:
            return "ring_x"
        if len(xs) == 1:
            return "ring_y"
        return "block_2d"

    # -- per-link latencies (consumed by the event fabric) ----------------

    def link_latency_s(self, link_name: str) -> float:
        """Propagation latency of one named link: DCN uplinks pay the
        cross-pod one-way latency, ICI links (and the bisection
        aggregates, which stand in for bundles of ICI wrap links) one
        torus hop.  Accepts both bare topology names (``pod0.dcn``,
        ``pod0.ici[0,1]+x``) and event-fabric component names
        (``fabric.pod0.dcn``)."""
        name = link_name[len("fabric."):] \
            if link_name.startswith("fabric.") else link_name
        if name.endswith(".dcn"):
            return self.spec.chip.dcn_latency_s
        return self.spec.chip.ici_hop_latency_s

    def min_link_latency_s(self) -> float:
        """Smallest per-hop latency any fabric link carries.  This bounds
        the latency budget the event fabric may put on its bus legs (and
        therefore the lookahead window its clusters run under): every
        transfer's step latency must cover the request leg plus the
        ack/chunk leg, so no leg may exceed a fraction of this."""
        return min(self.spec.chip.ici_hop_latency_s,
                   self.spec.chip.dcn_latency_s)

    # -- per-collective analytic times (seconds) --------------------------
    # B = full (unsharded-along-group) payload bytes handled per participant,
    # i.e. the operand bytes of the HLO op for all-reduce / all-to-all /
    # collective-permute, and the *output* bytes for all-gather, input
    # bytes for reduce-scatter.

    def _ring_time(self, B: float, n: int, phases: float) -> float:
        """phases = 2 for all-reduce (RS+AG), 1 for AG or RS alone.
        Bidirectional ring: both directions used -> effective 2x link bw."""
        c = self.spec.chip
        bw = 2 * c.ici_link_bandwidth
        steps = phases * (n - 1)
        return phases * (n - 1) / n * B / bw + steps * c.ici_hop_latency_s

    def _block2d_time(self, B: float, n: int, phases: float) -> float:
        """Hierarchical: phase along x rings then y rings (B shrinks by X)."""
        nx = min(self.X, n)
        ny = max(1, n // nx)
        t = self._ring_time(B, nx, phases)
        if ny > 1:
            t += self._ring_time(B / nx, ny, phases)
        return t

    def _alltoall_ring_time(self, B: float, n: int) -> float:
        """Uniform all-to-all on a bidirectional ring: per-link load
        ~ B*(n-1)/8 (avg shortest-path distance n/4 over 2n directed links)."""
        c = self.spec.chip
        return (B * (n - 1) / 8) / c.ici_link_bandwidth + (n / 2) * c.ici_hop_latency_s

    def _alltoall_block_time(self, B: float, n: int) -> float:
        """Bisection-limited uniform all-to-all over a 2-D block."""
        cross = n * B / 2
        return cross / self.spec.bisection_bandwidth_per_pod + \
            (self.X / 2 + self.Y / 2) * self.spec.chip.ici_hop_latency_s

    def _cross_pod_time(self, kind: str, B: float, n: int,
                        n_groups: int) -> float:
        """Groups span pods: hierarchical intra-pod + DCN exchange.

        For the common pod-axis case (each group has one chip per pod),
        every group moves B bytes across DCN simultaneously; the pod's
        aggregate DCN bandwidth is shared by all concurrent groups."""
        c = self.spec.chip
        pods = self.spec.num_pods
        per_pod_members = max(1, n // pods)
        t = 0.0
        eff = 1.0
        if kind in ("all-reduce", "reduce-scatter"):
            eff = 2 * (pods - 1) / pods if kind == "all-reduce" else (pods - 1) / pods
        elif kind in ("all-gather", "all-to-all", "collective-permute"):
            eff = (pods - 1) / pods
        if per_pod_members > 1:
            # intra-pod phase first (reduce-scatter or gather within pod)
            t += self._block2d_time(B, per_pod_members, 1.0)
            B = B / per_pod_members
        dcn_bytes_per_pod = n_groups * B * eff
        t += dcn_bytes_per_pod / self.spec.dcn_bandwidth_per_pod + c.dcn_latency_s
        if per_pod_members > 1 and kind in ("all-reduce", "all-gather"):
            t += self._block2d_time(B * per_pod_members, per_pod_members, 1.0)
        return t

    def price(self, kind: str, bytes_per_shard: float,
              groups: typing.List[typing.List[int]]) -> float:
        """Pure analytic time for one collective op.

        Stateless: never touches the per-link byte counters, so batched
        (vectorized) pricing over a whole grid may call the same
        formulas without mutating fabric occupancy mid-grid.  The
        vectorized mirror lives in :mod:`repro.fabric.pricing`; this
        scalar path is its parity oracle (``tests/test_pricing.py``
        asserts exact float equality).
        """
        if not groups or len(groups[0]) <= 1:
            return 0.0
        return self.price_point(kind, self.classify_group(groups[0]),
                                float(bytes_per_shard), len(groups[0]),
                                n_groups=len(groups))

    def price_point(self, kind: str, cls: str, B: float, n: int,
                    n_groups: int = 1) -> float:
        """Analytic time for one (kind, group-class, bytes, size) point
        with the class given explicitly rather than derived from group
        membership.  This is the scalar oracle the vectorized kernels
        in :mod:`repro.fabric.pricing` are tested against point by
        point: same expression trees, so equality is exact."""
        if n <= 1:
            return 0.0
        if cls == "cross_pod":
            return self._cross_pod_time(kind, B, n, n_groups)
        if kind == "all-reduce":
            return self._ring_time(B, n, 2.0) if cls.startswith("ring") else \
                self._block2d_time(B, n, 2.0)
        if kind in ("all-gather", "reduce-scatter"):
            return self._ring_time(B, n, 1.0) if cls.startswith("ring") else \
                self._block2d_time(B, n, 1.0)
        if kind == "all-to-all":
            return self._alltoall_ring_time(B, n) if cls.startswith("ring") \
                else self._alltoall_block_time(B, n)
        if kind == "collective-permute":
            c = self.spec.chip
            return B / c.ici_link_bandwidth + c.ici_hop_latency_s
        raise ValueError(f"unknown collective kind {kind!r}")

    def debit_links(self, kind: str, bytes_per_shard: float,
                    groups: typing.List[typing.List[int]]) -> None:
        """Charge one collective's traffic to the per-link byte counters
        (the analytic occupancy report).  Explicitly separate from
        :meth:`price` so pricing stays pure; ``collective_time_s``
        composes the two for the live simulation path."""
        if not groups or len(groups[0]) <= 1:
            return
        n = len(groups[0])
        cls = self.classify_group(groups[0])
        B = float(bytes_per_shard)
        if cls == "cross_pod":
            share = B * (len(groups) / max(1, self.spec.num_pods))
            for l in self.dcn:
                l.bytes_total += share
            return
        if kind == "all-reduce":
            per_link = 2 * (n - 1) / n * B / 2
        elif kind in ("all-gather", "reduce-scatter"):
            per_link = (n - 1) / n * B / 2
        elif kind == "all-to-all":
            per_link = B * (n - 1) / 8
        elif kind == "collective-permute":
            per_link = B
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        self._debit_links(groups, cls, per_link)

    def collective_time_s(self, kind: str, bytes_per_shard: float,
                          groups: typing.List[typing.List[int]]) -> float:
        """Time for one collective op; also debits link byte counters."""
        t = self.price(kind, bytes_per_shard, groups)
        self.debit_links(kind, bytes_per_shard, groups)
        return t

    def _debit_links(self, groups, cls, per_link_bytes: float) -> None:
        axis = "x" if cls == "ring_x" or cls == "block_2d" else "y"
        for group in groups:
            for d in group:
                pod, y, x = self.coords(d)
                self.links[f"pod{pod}.ici[{y},{x}]+{axis}"].bytes_total += per_link_bytes

    def link_report(self) -> dict:
        hot = sorted(self.links.values(), key=lambda l: -l.bytes_total)[:8]
        return {
            "hottest_links": [(l.name, l.bytes_total) for l in hot if l.bytes_total],
            "dcn_bytes": [(l.name, l.bytes_total) for l in self.dcn],
        }
