"""Three-term roofline analysis (assignment §Roofline).

For each (architecture × shape × mesh) cell the dry-run produces:

* ``compiled.cost_analysis()``  -> HLO FLOPs + HBM bytes of the
  **per-device** partitioned module (verified in
  ``tests/test_roofline.py::test_cost_analysis_is_per_device``);
* our own HLO parse (:mod:`repro.core.hlo`)  -> collective payload bytes
  per device, *scaled by while-loop trip counts* (XLA's cost_analysis
  counts loop bodies once — our parser is the trustworthy source for
  anything under a ``jax.lax.scan``).

Terms (seconds), following the assignment's definitions with the global/
per-device convention made explicit:

    compute    = FLOPs_global  / (chips * peak)    == flops_per_dev / peak
    memory     = bytes_global  / (chips * hbm_bw)  == bytes_per_dev / hbm_bw
    collective = coll_bytes_per_dev / ici_link_bw  (spec formula)

plus a topology-aware estimate ``collective_sim`` from
:class:`repro.core.topology.Topology`'s analytic ring/torus/DCN models,
which accounts for ring efficiency (n-1)/n factors, bidirectional links
and DCN hops — the number the perf loop actually optimizes against.

MODEL_FLOPS conventions per cell kind:
    train:   6 * N_active * tokens          (fwd 2x + bwd 4x)
    prefill: 2 * N_active * tokens  + attention term
    decode:  2 * N_active * new_tokens (=batch) + KV-read attention term
"""
from __future__ import annotations

import dataclasses
import typing

from .hw import ChipSpec, SystemSpec
from .hlo import HloCost
from .topology import Topology


@dataclasses.dataclass
class RooflineTerms:
    cell: str                      # "arch/shape"
    mesh: str                      # e.g. "(16,16)"
    chips: int
    # raw per-device quantities
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: float
    coll_bytes_by_kind: dict
    # derived times (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0      # spec formula
    t_collective_sim: float = 0.0  # topology-aware analytic estimate
    # usefulness
    model_flops_global: float = 0.0
    useful_ratio: float = 0.0      # MODEL_FLOPS / HLO_FLOPs (global)
    dominant: str = ""
    bound_time: float = 0.0        # max of the three terms
    roofline_fraction: float = 0.0  # t_compute / bound_time (MFU-at-bound)
    notes: str = ""

    def finalize(self, spec: SystemSpec) -> "RooflineTerms":
        c = spec.chip
        self.t_compute = self.flops_per_device / c.peak_bf16_flops
        self.t_memory = self.hbm_bytes_per_device / c.hbm_bandwidth
        self.t_collective = self.coll_bytes_per_device / c.ici_link_bandwidth
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": max(self.t_collective, self.t_collective_sim)}
        self.dominant = max(terms, key=terms.get)
        self.bound_time = max(terms.values())
        if self.bound_time > 0:
            self.roofline_fraction = self.t_compute / self.bound_time
        if self.model_flops_global and self.flops_per_device:
            self.useful_ratio = self.model_flops_global / (
                self.flops_per_device * self.chips)
        return self


def collective_sim_time(cost: HloCost, spec: SystemSpec) -> float:
    """Price every parsed collective with the topology's analytic model."""
    topo = Topology(spec)
    total = 0.0
    for rec in cost.collectives:
        if not rec.groups or len(rec.groups[0]) <= 1:
            continue
        t = topo.collective_time_s(rec.kind, rec.payload_bytes, rec.groups)
        total += t * rec.count
    return total


def build_terms(cell: str, mesh_name: str, chips: int,
                cost_analysis: dict, hlo_cost: HloCost,
                spec: SystemSpec, model_flops_global: float = 0.0,
                notes: str = "") -> RooflineTerms:
    """Assemble roofline terms from the dry-run artifacts.

    ``cost_analysis`` is ``compiled.cost_analysis()`` (per-device module).
    ``hlo_cost`` is our parse of the same module's HLO text; its FLOPs are
    used *only* as a fallback when cost_analysis undercounts loops (we take
    the max — both are per-device quantities for the same program).
    """
    ca_flops = float(cost_analysis.get("flops", 0.0))
    ca_bytes = float(cost_analysis.get("bytes accessed", 0.0))
    flops = max(ca_flops, hlo_cost.flops)
    # bytes: prefer our parse — it scales while-loop bodies by trip count
    # (XLA counts them once) AND credits in-place dynamic-update-slice
    # (XLA bills a full buffer copy); fall back to XLA if parsing found
    # nothing.
    hbm = hlo_cost.hbm_bytes if hlo_cost.hbm_bytes > 0 else ca_bytes
    terms = RooflineTerms(
        cell=cell, mesh=mesh_name, chips=chips,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        coll_bytes_per_device=hlo_cost.collective_bytes,
        coll_bytes_by_kind=hlo_cost.collective_bytes_by_kind(),
        model_flops_global=model_flops_global,
        t_collective_sim=collective_sim_time(hlo_cost, spec),
        notes=notes,
    )
    return terms.finalize(spec)


# --------------------------------------------------------------------------
# MODEL_FLOPS helpers
# --------------------------------------------------------------------------

def model_flops_train(n_active_params: float, tokens: float) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_prefill(n_active_params: float, tokens: float,
                        attn_flops: float = 0.0) -> float:
    return 2.0 * n_active_params * tokens + attn_flops


def model_flops_decode(n_active_params: float, new_tokens: float,
                       kv_read_flops: float = 0.0) -> float:
    return 2.0 * n_active_params * new_tokens + kv_read_flops


def attention_flops(batch: int, seq: int, heads: int, head_dim: int,
                    layers: int, causal: bool = True) -> float:
    """QK^T + PV flops for full attention (training fwd; x3 for bwd)."""
    full = 2.0 * batch * heads * seq * seq * head_dim * 2 * layers
    return full / 2 if causal else full


def fmt_seconds(t: float) -> str:
    if t == 0:
        return "0"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6), ("ns", 1e-9)):
        if t >= scale:
            return f"{t / scale:.3g}{unit}"
    return f"{t:.2e}s"


def format_table(rows: typing.List[RooflineTerms]) -> str:
    hdr = ["cell", "mesh", "chips", "t_compute", "t_memory", "t_coll(spec)",
           "t_coll(sim)", "dominant", "useful", "roofline%"]
    lines = [" | ".join(hdr), " | ".join(["---"] * len(hdr))]
    for r in rows:
        lines.append(" | ".join([
            r.cell, r.mesh, str(r.chips),
            fmt_seconds(r.t_compute), fmt_seconds(r.t_memory),
            fmt_seconds(r.t_collective), fmt_seconds(r.t_collective_sim),
            r.dominant,
            f"{r.useful_ratio:.2f}" if r.useful_ratio else "-",
            f"{100 * r.roofline_fraction:.1f}%",
        ]))
    return "\n".join(lines)
