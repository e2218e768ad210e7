"""LookaheadScheduler -- conservative PDES with an auto-derived window.

Executes *all* events in ``[t, t + lookahead)`` concurrently, not just
exact timestamp ties.  Safety argument (classic conservative parallel
discrete-event simulation, cf. ACALSim / Huerta 2025):

* Components are partitioned into *clusters*: a connection whose send
  path is zero-latency or mutates shared state fuses with its endpoint
  owners, and components declaring a shared ``cluster_affinity`` fuse
  with each other (``Engine.compute_clusters`` -- the event fabric uses
  affinity to make each chip's DMA engine + ICI links one cluster while
  its latency-carrying bus keeps distinct chips, the pod DCN/bisection
  links and the controller un-fused).  Within a cluster execution is
  sequential in (time, rank, seq) order -- exactly serial's relative
  order for those components.
* Across clusters, events can only be created by ``Connection.send``,
  which posts both the deliver event and the destination's request event
  ``transfer_time >= min_latency_ps`` in the future.  With ``lookahead =
  min over non-fused connections of min_latency_ps``, no event executed
  inside the window can target another cluster before the window ends --
  so clusters cannot observe each other mid-window and any execution
  interleaving yields the serial result.
* The commit phase orders newly created events by the serial post-order
  stamp, so global seq assignment (the last tie-break) matches serial.

A cross-cluster post inside the window raises ``RuntimeError`` rather
than silently corrupting determinism.
"""
from __future__ import annotations

from .base import RoundScheduler, register_scheduler

_INF = float("inf")


class LookaheadScheduler(RoundScheduler):
    name = "lookahead"
    use_pool = True
    strict_window = True
    record_window_widths = True
    # In-window events a cluster schedules for itself run locally; the
    # cluster fusion of zero-latency connections keeps that serial-ordered.
    defer_all_posts = False

    def __init__(self, max_workers: int = 4, lookahead_ps: int = None) -> None:
        super().__init__(max_workers)
        self.lookahead_ps = lookahead_ps    # None -> derive from topology
        self.window_ps = None               # resolved at run() time

    def prepare(self) -> None:
        super().prepare()                   # clusters + sharded queue + ctxs
        if self.lookahead_ps is not None:
            self.window_ps = self.lookahead_ps
        else:
            auto = self.engine.min_cross_cluster_latency_ps()
            # No cross-cluster channel => clusters never interact and the
            # window is unbounded; a zero/negative derivation degrades to
            # one-tick windows (same-timestamp batches).
            self.window_ps = (None if auto is None else max(1, auto))

    def window_end(self, t: int):
        return _INF if self.window_ps is None else t + self.window_ps

    def describe(self) -> dict:
        d = super().describe()
        d["window_ps"] = self.window_ps
        return d


register_scheduler("lookahead", LookaheadScheduler)


class BoundedLagScheduler(LookaheadScheduler):
    """Lookahead without the global round barrier.

    Identical conservative-PDES safety story, but the one topology-wide
    window (``min over non-fused connections of min_latency_ps``) is
    replaced by per-cluster horizons derived from the *cluster graph*
    (``Engine.cluster_graph``): a cluster only synchronizes with the
    clusters it actually exchanges events with, so decoupled subsystems
    -- distinct tenants, compute islands between collectives, separate
    pods -- advance independently instead of paying one global sync
    point per window tick.  Bit-identity to serial is kept by staging
    cross-wave posts with their serial post-order stamps and assigning
    seqs only at each shard's flush (see
    ``RoundScheduler._run_bounded``).

    ``lookahead_ps`` is ignored in this mode: the per-edge latencies in
    the cluster graph *are* the lookahead, edge by edge.
    """

    name = "bounded"
    bounded_lag = True


register_scheduler("bounded", BoundedLagScheduler)
