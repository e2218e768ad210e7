"""Hook system (paper Sec. 4.1, part 4).

Hooks are small pieces of software attached to the engine, components or
connections.  They read (or, for fault injection, perturb) simulation
state without being part of the critical protocol path.  Used here for:
trace collection, performance metrics, stall accounting and fault /
straggler injection -- the same four uses the paper lists.
"""
from __future__ import annotations

import collections
import dataclasses
import typing

from .hw import ps_to_s

# Hook positions
EVENT_START = "event_start"
EVENT_END = "event_end"
REQ_SEND = "request_send"
REQ_DELIVER = "request_deliver"
BUSY_INTERVAL = "busy_interval"   # payload: (component, start_ps, end_ps, tag)


@dataclasses.dataclass(frozen=True)
class HookCtx:
    position: str
    time: int
    item: typing.Any          # Event or Request or tuple
    owner: typing.Any = None  # component/connection the hook fired on


class Hook:
    """Base hook: override ``func``.

    Shard residency (``executor="procs"``): engine-level hooks fire in
    every shard worker on that worker's replica of the hook, so their
    observations end the run partitioned across processes.  A hook that
    defines ``merge_shard(self, replica)`` gets each worker's replica
    merged back into the parent instance at the end of the run (the
    method must be commutative across replicas -- counter sums, maxima).
    Because the workers fork *with* the parent's pre-run state, each
    one swaps the engine-level hook for :meth:`fresh_shard` at startup
    and accumulates only its own observations -- otherwise the fork
    baseline (e.g. a previous run's counters) would merge back once
    per worker.  Hooks without ``merge_shard`` keep only parent-side
    observations under procs; their *side effects on components* (e.g.
    FaultInjector's fault flags) still replicate faithfully, because
    those live in component state, which is shard-resident and synced
    back.  See docs/engine.md.
    """

    def fresh_shard(self) -> "Hook":
        """A zero-state instance for a shard worker to accumulate into.
        The default assumes a zero-argument constructor; mergeable
        hooks with required constructor arguments must override."""
        return type(self)()

    def func(self, ctx: HookCtx) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class Hookable:
    """Mixin giving engine/components/connections a hook list.

    ``hooks_active`` is the hot-path fast flag: hook-free items (the
    overwhelmingly common case -- fault/trace hooks attach to a handful
    of components) pay one attribute check per event instead of four
    ``invoke_hooks`` calls.  It is a class attribute shadowed by an
    instance attribute on the first ``accept_hook``, so the flag costs
    nothing per instance until a hook actually attaches.
    """

    hooks_active = False

    def __init__(self) -> None:
        self._hooks: list = []

    def accept_hook(self, hook: Hook) -> None:
        self._hooks.append(hook)
        self.hooks_active = True

    def invoke_hooks(self, position: str, time: int, item: typing.Any) -> None:
        for h in self._hooks:
            h.func(HookCtx(position=position, time=time, item=item, owner=self))


class Tracer(Hook):
    """Records every hook firing (bounded) -- debugging / validation."""

    def __init__(self, limit: int = 1_000_000) -> None:
        self.records: list = []
        self.limit = limit

    def func(self, ctx: HookCtx) -> None:
        if len(self.records) < self.limit:
            self.records.append(ctx)


class MetricsHook(Hook):
    """Aggregates busy time per component and request bytes per connection."""

    def __init__(self) -> None:
        self.busy_ps = collections.Counter()        # name -> busy picoseconds
        self.busy_by_tag = collections.Counter()    # (name, tag) -> ps
        self.bytes_sent = collections.Counter()     # connection name -> bytes
        self.requests = collections.Counter()       # connection name -> count
        self.end_time_ps = 0

    def func(self, ctx: HookCtx) -> None:
        if ctx.position == BUSY_INTERVAL:
            comp, start, end, tag = ctx.item
            self.busy_ps[comp.name] += end - start
            self.busy_by_tag[(comp.name, tag)] += end - start
            self.end_time_ps = max(self.end_time_ps, end)
        elif ctx.position == REQ_SEND:
            req = ctx.item
            self.bytes_sent[ctx.owner.name] += getattr(req, "size_bytes", 0)
            self.requests[ctx.owner.name] += 1
        if ctx.position in (EVENT_END, REQ_DELIVER):
            self.end_time_ps = max(self.end_time_ps, ctx.time)

    def merge_shard(self, replica: "MetricsHook") -> None:
        """Fold a shard worker's observations into this instance: each
        worker saw a disjoint partition of the events, so counters sum
        and the end time is the max (order-independent across workers)."""
        self.busy_ps.update(replica.busy_ps)
        self.busy_by_tag.update(replica.busy_by_tag)
        self.bytes_sent.update(replica.bytes_sent)
        self.requests.update(replica.requests)
        self.end_time_ps = max(self.end_time_ps, replica.end_time_ps)

    def utilization(self, name: str) -> float:
        if self.end_time_ps == 0:
            return 0.0
        return self.busy_ps[name] / self.end_time_ps

    def summary(self) -> dict:
        return {
            "end_time_s": ps_to_s(self.end_time_ps),
            "busy_s": {k: ps_to_s(v) for k, v in self.busy_ps.items()},
            "bytes_sent": dict(self.bytes_sent),
        }


class StallHook(Hook):
    """Counts stall reasons announced by components (kind='stall')."""

    def __init__(self) -> None:
        self.stalls = collections.Counter()

    def merge_shard(self, replica: "StallHook") -> None:
        self.stalls.update(replica.stalls)

    def func(self, ctx: HookCtx) -> None:
        if ctx.position == EVENT_START and getattr(ctx.item, "kind", "") == "stall":
            self.stalls[ctx.item.payload] += 1


class FaultInjector(Hook):
    """Injects failures / stragglers into components at given times.

    ``plan`` maps component-name -> list of (time_ps, action, arg):
      * ("fail", None)           -- component stops handling events
      * ("drop", None)           -- alias for "fail": events addressed to
                                    the component are dropped on the
                                    floor (the natural reading for a
                                    link: in-flight transfers are lost)
      * ("slow", factor)         -- durations multiplied by factor
      * ("recover", None)        -- undo both
      * ("transient", dur_ps)    -- sugar: "fail" now, auto-"recover"
                                    ``dur_ps`` later (a flapping link /
                                    glitching component).  Anything lost
                                    during the outage stays lost --
                                    under the event fabric's ring
                                    dependency a transient link fault
                                    therefore stalls the whole ring, not
                                    just the sender's chain.

    Targets are chips (``chip3.core`` compute straggler, ``chip3.prog``
    failure) and, under the event fabric, individual interconnect links
    and DMA engines (``fabric.pod0.ici[0,1]+x`` -> a *straggler link*:
    every transfer crossing it stretches by ``factor``).  The full plan
    grammar with worked examples lives in docs/faults.md.
    The injector flips flags that well-behaved components consult inside
    their own ``handle`` -- state is still only mutated by the owner
    (no-magic is preserved: the hook only sets an *input* flag the
    component reads, the same way MGSim injects faults).
    """

    def __init__(self, plan: dict) -> None:
        self.plan = {k: sorted(self._expand(v)) for k, v in plan.items()}

    def arm(self, components: typing.Iterable) -> None:
        """Post a ``fault_wake`` self-event at every plan time of every
        planned target, so actions apply *exactly on schedule* even when
        no other traffic reaches the component.  Without this the lazy
        pop in :meth:`func` only fires at the component's next event --
        a ``recover`` on an idle, failed component (which receives
        nothing: the engine drops its events) would apply late or never.
        The wake rides the normal dispatch path: the hook applies due
        actions at EVENT_START, then the (possibly just-recovered)
        component handles a ``fault_wake`` event it may react to --
        components that don't know the kind ignore it.  Call after the
        targets accepted this hook, before ``engine.run()``."""
        from .event import Event   # local: hooks must not import event at load
        for comp in components:
            for t, _action, _arg in self.plan.get(comp.name, ()):
                comp.engine.post(Event(time=t, component=comp,
                                       kind="fault_wake"))

    @staticmethod
    def _expand(actions):
        out = []
        for t, action, arg in actions:
            if action == "transient":
                out.append((t, "fail", None))
                out.append((t + int(arg), "recover", None))
            elif action == "drop":
                out.append((t, "fail", None))
            else:
                out.append((t, action, arg))
        return out

    def func(self, ctx: HookCtx) -> None:
        if ctx.position != EVENT_START:
            return
        comp = ctx.owner
        name = getattr(comp, "name", None)
        actions = self.plan.get(name)
        if not actions:
            return
        while actions and actions[0][0] <= ctx.time:
            _, action, arg = actions.pop(0)
            if action == "fail":
                comp.fault_failed = True
            elif action == "slow":
                comp.fault_slow_factor = float(arg)
            elif action == "recover":
                comp.fault_failed = False
                comp.fault_slow_factor = 1.0
