"""Hardware constants for the modeled TPU system.

The assignment's target is a TPU v5e-class chip:
  * 197 TFLOP/s peak bf16 per chip
  * 819 GB/s HBM bandwidth per chip
  * ~50 GB/s per ICI link (2-D torus, 4 links per chip)

Pods are 16x16 = 256 chips; pods are connected over DCN. All values are
configurable so the same simulator can model other parts (v4, v5p, TRN)
by swapping a ChipSpec/SystemSpec -- the simulator core never hardcodes
these numbers (paper DP-2: open to extension).
"""
from __future__ import annotations

import dataclasses

# Time is tracked in integer picoseconds to keep event ordering exact.
PS_PER_S = 1_000_000_000_000


def s_to_ps(seconds: float) -> int:
    return int(round(seconds * PS_PER_S))


def ps_to_s(ps: int) -> float:
    return ps / PS_PER_S


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip performance envelope."""

    name: str = "tpu-v5e"
    peak_bf16_flops: float = 197e12     # FLOP/s
    peak_f32_flops: float = 98.5e12     # FLOP/s (half of bf16 MXU rate)
    hbm_bandwidth: float = 819e9        # bytes/s
    hbm_capacity: int = 16 * 1024**3    # bytes
    vmem_capacity: int = 128 * 1024**2  # bytes (v5e ~128MiB VMEM)
    ici_link_bandwidth: float = 50e9    # bytes/s per link per direction
    ici_links: int = 4                  # 2-D torus: +x, -x, +y, -y
    clock_hz: float = 0.94e9            # nominal core clock
    # Fixed overheads (fit once by the micro-benchmarks, Fig.6-analog):
    op_launch_overhead_s: float = 1.2e-6     # per fused-op dispatch
    ici_hop_latency_s: float = 1.0e-6        # per-hop ICI latency
    dcn_latency_s: float = 10.0e-6           # cross-pod one-way latency
    hbm_latency_s: float = 0.6e-6            # first-byte HBM latency

    def flops_for_dtype(self, dtype_bits: int) -> float:
        return self.peak_f32_flops if dtype_bits >= 32 else self.peak_bf16_flops


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A multi-pod system: `num_pods` pods of `pod_shape` torus chips."""

    chip: ChipSpec = dataclasses.field(default_factory=ChipSpec)
    pod_shape: tuple = (16, 16)          # 2-D ICI torus per pod
    num_pods: int = 1
    dcn_bandwidth_per_pod: float = 1.6e12  # bytes/s aggregate per pod
    # (256-chip v5e pod = 64 hosts x ~25 GB/s effective NIC each)
    # Control-plane hop between a device and the collective coordinator
    # (one ICI-hop-class latency each way).  Also the only cross-chip
    # channel in the component graph, so it bounds the conservative
    # lookahead window the parallel engine derives (engine/lookahead.py).
    ctrl_latency_s: float = 1.0e-6
    # Interconnect model: a repro.fabric backend name -- "analytic"
    # (closed-form pricing, the fast path) or "event" (per-hop transfer
    # events with link contention).  See docs/fabric.md.
    fabric: str = "analytic"

    @property
    def chips_per_pod(self) -> int:
        n = 1
        for d in self.pod_shape:
            n *= d
        return n

    @property
    def total_chips(self) -> int:
        return self.chips_per_pod * self.num_pods

    @property
    def bisection_bandwidth_per_pod(self) -> float:
        """2-D torus bisection: 2 * min_dim wrap pairs * 2 dirs * link bw."""
        min_dim = min(self.pod_shape)
        return 2 * min_dim * 2 * self.chip.ici_link_bandwidth


# The production system used throughout the assignment.
SINGLE_POD = SystemSpec(num_pods=1)
MULTI_POD = SystemSpec(num_pods=2)

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
    "token": 0, "opaque": 0,
}
