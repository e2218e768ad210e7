"""BatchParallelScheduler -- the paper's DP-5 conservative scheme.

All events sharing the earliest timestamp form one batch; the batch is
grouped into component clusters and the groups run concurrently on a
thread pool (a cluster's state is only touched by its own group).
Newly created events all commit afterwards in serial post order, so the
result is bit-identical to serial execution.

Grouping is by ``Engine.compute_clusters`` (the ``RoundScheduler``
default) rather than raw component rank: components sharing a stateful
connection (``LinkConnection`` occupancy, attached hooks) mutate that
connection's state from inside their handlers, so they must not run on
different threads even at the same timestamp.

Limitation this scheduler inherits from the paper's scheme: it only
parallelizes *exact* timestamp ties.  Traces whose per-component op
latencies diverge degrade to batch width 1 -- that is what
:class:`repro.core.engine.lookahead.LookaheadScheduler` fixes.
"""
from __future__ import annotations

from .base import RoundScheduler, register_scheduler


class BatchParallelScheduler(RoundScheduler):
    name = "batch"
    use_pool = True

    # RoundScheduler defaults provide the rest of DP-5: one-tick windows
    # (same-timestamp batches) with every post deferred to the commit,
    # per-cluster grouping, and the cluster-sharded event queue.
    # ``bounded_lag`` stays False: the paper's scheme is *defined* by
    # the global same-timestamp barrier -- removing it turns this into
    # the bounded scheduler (``scheduler="bounded"``), which subsumes
    # batch whenever per-cluster horizons are wanted.


register_scheduler("batch", BatchParallelScheduler)
