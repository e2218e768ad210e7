"""Thread-pool executor -- the compatibility default.

Exactly PR 4's pool, relocated behind the executor interface: a
long-lived ``ThreadPoolExecutor`` with sticky ``cluster_id %
max_workers`` buckets, so a cluster always executes on the same worker
thread and its components never migrate.  State stays in the one shared
address space, which is what lets the scheduler keep its adaptive
merged / degenerate inline paths (``inline_rounds = True``).

The pool only engages when the round is wide enough to amortize the
~100us dispatch (``pool_min_events``) AND spans more than one bucket;
narrower grouped rounds run inline on the scheduler thread.  Under
CPython's GIL pure-Python handlers gain nothing physical from the pool
either way -- the regime where threads *do* scale is GIL-releasing
handlers / free-threaded builds; for real cores today use
``executor="procs"``.
"""
from __future__ import annotations

import concurrent.futures

from .base import Executor, register_executor


def _run_chunk(chunk) -> None:
    for ctx in chunk:
        ctx.execute()


class ThreadExecutor(Executor):
    name = "threads"
    inline_rounds = True

    def __init__(self, max_workers: int = 4) -> None:
        super().__init__(max_workers)
        self._pool = None
        self._buckets: list = []

    def prepare(self, ctxs: list) -> None:
        self._buckets = [[] for _ in range(max(1, self.max_workers))]

    def run_round(self, tasks: list, nev: int) -> None:
        sched = self.scheduler
        nworkers = self.max_workers
        if (sched.use_pool and nworkers > 1 and len(tasks) > 1
                and nev >= sched.pool_min_events):
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(nworkers)
            buckets = self._buckets
            for b in buckets:
                b.clear()
            for ctx in tasks:           # sticky cluster -> worker
                buckets[ctx.group_id % nworkers].append(ctx)
            list(self._pool.map(_run_chunk, [b for b in buckets if b]))
        else:
            for ctx in tasks:
                ctx.execute()

    def finalize(self, failed: bool = False) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def describe(self) -> dict:
        return {"name": self.name, "max_workers": self.max_workers}


register_executor("threads", ThreadExecutor)
