"""SerialScheduler -- the determinism oracle.

Processes events strictly in ``(time, component_rank, seq)`` order with
no pending buffers, no worker pool and no commit phase: every post goes
straight onto the global queue and receives its seq immediately.  This
is the reference semantics every other scheduler must reproduce
bit-identically (asserted by ``tests/test_sim_engine.py``).

The run loop installs a guarded direct-push sink (``guarded_push``):
in-thread posts keep the "cannot schedule into the past" causality
assert but skip the foreign-post lock (serial execution is
single-threaded by definition).  Note the engine's thread contract is
unchanged by this: ``Engine.post`` from a foreign thread is safe
against *other foreign threads* (the ``_post_lock`` fallback) and
against an idle engine, but has never been safe concurrent with an
actively draining run -- the run loop's pops do not take the lock, in
any scheduler, so mid-run foreign posting was and is unsupported
(post, then run -- see the foreign-thread stress tests).
"""
from __future__ import annotations

from .base import Scheduler, guarded_push, register_scheduler


class SerialScheduler(Scheduler):
    name = "serial"

    def run(self, until_ps: int = None) -> int:
        eng = self.engine
        queue = eng.queue
        tls = eng._tls
        prev_sink = getattr(tls, "sink", None)
        tls.sink = guarded_push(eng, queue)
        try:
            while queue:
                t = queue.peek_time()
                if until_ps is not None and t > until_ps:
                    break
                eng.now = t
                batch = queue.pop_batch()
                eng.batch_widths.append(len(batch))
                for ev in batch:
                    eng._handle_one(ev)
                eng.events_processed += len(batch)
        finally:
            tls.sink = prev_sink
        return eng.now


register_scheduler("serial", SerialScheduler)
