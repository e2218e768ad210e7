"""Scheduler x executor cases of the simulator parity tests.

Each case runs one workload on the port under a round scheduler and an
executor and holds it with ``==`` to the port's serial run; with
``with_ref`` it also holds the port's serial run to the reference's.
The test files run the ``threads`` cases in their own process and the
``procs`` cases through ``_torch_sim_nodes.run_in_child``, which imports
this module in a fresh interpreter.  Nothing here imports JAX: the
reference's serving simulator (which does, through
``repro/serve/__init__.py``) is loaded only when a serving case runs
``with_ref``, which the child never asks for.
"""
from __future__ import annotations

import importlib

import pytest

from _torch_sim_nodes import (ar_cost, build_jitter, grouped, pkg,
                              ring_cost, serve_sim)

SCHEDS = ("batch", "lookahead", "bounded")
CASES: dict = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _port():
    return pkg("repro_torch")


def _ref():
    return pkg("repro")


# ---------------------------------------------------------------------------
# the engine and its executors (tests/test_executor.py)
# ---------------------------------------------------------------------------

@case
def describe_reports_executor(executor, with_ref=True):
    p = _port()
    eng = p.core.Engine(scheduler="lookahead", executor=executor)
    eng.register(p.CountAll("a")).schedule("tick", 10)
    eng.run()
    desc = eng.scheduler.describe()
    assert desc["executor"]["name"] == executor
    if executor == "procs":
        assert desc["executor"]["processes"] >= 1


@case
def divergent_trace(sched, executor, with_ref=True):
    """The jitter ring under every scheduler x executor equals serial;
    under procs the node state is shard-resident until the end-of-run
    state sync."""
    p = _port()
    oracle, end_s, eng_s = build_jitter(p, "serial")
    got, end_p, eng_p = build_jitter(p, sched, executor)
    assert got == oracle and end_p == end_s
    assert eng_p.events_processed == eng_s.events_processed
    if with_ref:
        want, end_r, eng_r = build_jitter(_ref(), "serial")
        assert oracle == want and end_s == end_r
        assert eng_s.events_processed == eng_r.events_processed


def _sim_same(kw, sched, executor, with_ref, **extra):
    """simulate(**kw(ns)) on the port under ``sched`` x ``executor``
    against the port's serial run (and the reference's)."""
    p = _port()
    oracle = p.core.simulate(scheduler="serial", **kw(p), **extra)
    rep = p.core.simulate(scheduler=sched, executor=executor, **kw(p),
                          **extra)
    assert rep.summary() == oracle.summary()
    if with_ref:
        r = _ref()
        want = r.core.simulate(scheduler="serial", **kw(r), **extra)
        assert oracle.summary() == want.summary()
    return oracle, rep


def _small_ar(fabric):
    return lambda ns: dict(cost=ar_cost(ns),
                           spec=ns.core.SystemSpec(pod_shape=(2, 2)),
                           device_limit=None, fabric=fabric)


@case
def event_fabric_replay(executor, with_ref=True):
    """Timing, the metrics hook's busy time and link utilisation equal
    across executors: under procs that covers ``merge_shard`` and the
    fabric state shipped back from the workers."""
    oracle, rep = _sim_same(_small_ar("event"), "lookahead", executor,
                            with_ref)
    assert rep.executor == executor
    assert oracle.compute_busy_s > 0


@case
def analytic_link_report(executor, with_ref=True):
    oracle, rep = _sim_same(_small_ar("analytic"), "batch", executor,
                            with_ref)
    assert oracle.link_report["hottest_links"]
    assert rep.link_report == oracle.link_report


STRAGGLER = {"fabric.pod0.ici[0,0]+x": [(0.0, "slow", 6.0)]}
TRANSIENT = {"fabric.pod0.ici[0,1]+x": [(10e-6, "transient", 40e-6)]}


@case
def fault_injection(executor, with_ref=True):
    """A straggler-link plan perturbs a procs run exactly like a serial
    one: the FaultInjector replica fires inside the shard worker."""
    healthy = _port().core.simulate(scheduler="serial",
                                    **_small_ar("event")(_port()))
    oracle, rep = _sim_same(_small_ar("event"), "lookahead", executor,
                            with_ref, faults=STRAGGLER)
    assert rep.time_s > healthy.time_s


@case
def transient_fault(sched, executor, with_ref=True):
    healthy = _port().core.simulate(scheduler="serial",
                                    **_small_ar("event")(_port()))
    oracle, rep = _sim_same(_small_ar("event"), sched, executor, with_ref,
                            faults=TRANSIENT)
    assert oracle.summary() != healthy.summary()


def _rerun(ns, executor):
    eng = ns.core.Engine(scheduler="lookahead" if executor else "serial",
                         executor=executor)
    a, b = eng.register(ns.CountAll("a")), eng.register(ns.CountAll("b"))
    conn = eng.register(ns.core.Connection("c", latency_s=1e-6))
    conn.plug(a.port("x")).plug(b.port("x"))
    a.schedule("tick", 100)
    b.schedule("tick", 150)
    eng.run()
    mid = (a.received, b.received)
    a.schedule("tock", 50)
    b.schedule("tock", 75)
    end = eng.run()
    return mid, (a.received, b.received), end, eng.events_processed


@case
def engine_rerun(executor, with_ref=True):
    """A second run resumes from the state the first left behind."""
    oracle = _rerun(_port(), None)
    assert _rerun(_port(), executor) == oracle
    if with_ref:
        assert _rerun(_ref(), None) == oracle


def _partial(ns, executor, n=6, ticks=60):
    eng = ns.core.Engine(scheduler="lookahead" if executor else "serial",
                         executor=executor)
    nodes = [eng.register(ns.JitterNode(f"n{i}", i, ticks, send_every=10))
             for i in range(n)]
    for i in range(n):
        conn = eng.register(ns.core.Connection(f"ring{i}", latency_s=4e-9))
        conn.plug(nodes[i].port("out")).plug(nodes[(i + 1) % n].port("in"))
    for nd in nodes:
        nd.start()
    eng.run(until_ps=ticks * 300 // 2)
    mid = [(nd.sig, nd.count, nd.received) for nd in nodes]
    end = eng.run()
    return mid, [(nd.sig, nd.count, nd.received) for nd in nodes], end


@case
def partial_run_then_resume(executor, with_ref=True):
    oracle = _partial(_port(), None)
    assert oracle[0] != oracle[1]
    assert _partial(_port(), executor) == oracle
    if with_ref:
        assert _partial(_ref(), None) == oracle


def _spray(ns, executor):
    eng = ns.core.Engine(scheduler="lookahead" if executor else "serial",
                         executor=executor)
    n = 6
    nodes = [eng.register(ns.Spray(f"s{i}", 40)) for i in range(n)]
    for i in range(n):
        for pname, j in (("fwd", (i + 1) % n), ("bwd", (i - 1) % n)):
            conn = eng.register(ns.core.Connection(f"{pname}{i}",
                                                   latency_s=1e-6))
            conn.plug(nodes[i].port(pname)).plug(
                nodes[j].port(f"in{pname}{i}"))
    for nd in nodes:
        nd.start()
    eng.run(until_ps=40 * 137 // 2)
    eng.run()
    return [(nd.sig, nd.count) for nd in nodes]


@case
def blob_payloads_three_workers(executor, with_ref=True):
    """One worker's same-round blobs to two destination workers stay
    apart after a partial run (three worker processes)."""
    p = _port()
    if executor == "procs":
        ex = p.core.ProcExecutor(max_workers=4)
        ex._max_procs = 3
    else:
        ex = p.core.ThreadExecutor(max_workers=3)
    oracle = _spray(p, None)
    assert _spray(p, ex) == oracle
    if with_ref:
        assert _spray(_ref(), None) == oracle


def _stalls(ns, executor):
    eng = ns.core.Engine(scheduler="lookahead" if executor else "serial",
                         executor=executor)
    hook = ns.hooks.StallHook()
    eng.accept_hook(hook)
    s = eng.register(ns.Staller("s"))
    s.start()
    eng.run()
    first = dict(hook.stalls)
    s.schedule("stall", 50, payload="y")
    eng.run()
    return first, dict(hook.stalls)


@case
def hook_state_not_double_counted(executor, with_ref=True):
    want = ({"x": 3}, {"x": 3, "y": 1})
    assert _stalls(_port(), executor) == _stalls(_port(), None) == want
    if with_ref:
        assert _stalls(_ref(), None) == want


def _component_hook(ns, executor):
    eng = ns.core.Engine(scheduler="lookahead" if executor else "serial",
                         executor=executor)
    s = eng.register(ns.Staller("s"))
    other = eng.register(ns.CountAll("o"))
    other.schedule("tick", 10)
    hook = ns.hooks.StallHook()
    s.accept_hook(hook)
    s.start()
    eng.run()
    return dict(hook.stalls)


@case
def component_hook_merges_back(executor, with_ref=True):
    assert _component_hook(_port(), executor) == \
        _component_hook(_port(), None) == {"x": 3}
    if with_ref:
        assert _component_hook(_ref(), None) == {"x": 3}


@case
def procs_clamps_idle_workers(executor="procs", with_ref=True):
    p = _port()
    eng = p.core.Engine(scheduler="lookahead", max_workers=4,
                        executor="procs")
    eng.register(p.CountAll("only")).schedule("tick", 10)
    eng.run()
    assert eng.scheduler.executor.processes == 1


def _backpressure(ns, scheduler, executor=None):
    eng = ns.core.Engine(scheduler=scheduler, executor=executor)
    prod = eng.register(ns.Producer("p", total=25))
    sink = eng.register(ns.Sink("s"))
    conn = eng.register(ns.core.LimitedConnection(
        "lim", bandwidth=1e9, latency_s=1e-6, capacity=3))
    conn.plug(prod.port("out")).plug(sink.port("in"))
    prod.start()
    eng.run()
    return (prod.sent, prod.rejected, prod.notified, sink.received,
            eng.events_processed)


@case
def limited_connection_backpressure(executor, with_ref=True):
    oracle = _backpressure(_port(), "serial")
    assert _backpressure(_port(), "lookahead", executor) == oracle
    assert oracle[1] > 0 and oracle[2] > 0
    if with_ref:
        assert _backpressure(_ref(), "serial") == oracle


@case
def worker_crash_raises(executor="procs", with_ref=True):
    p = _port()
    eng = p.core.Engine(scheduler="lookahead", executor="procs")
    eng.register(p.Suicider("boom")).start()
    with pytest.raises(RuntimeError, match="died mid-run"):
        eng.run()


@case
def worker_exception_propagates(executor="procs", with_ref=True):
    p = _port()
    eng = p.core.Engine(scheduler="lookahead", executor="procs")
    eng.register(p.Thrower("t")).start()
    with pytest.raises(RuntimeError, match="handler exploded"):
        eng.run()


@case
def strict_window_guard(executor, with_ref=True):
    """A zero-latency post at a foreign cluster raises the lookahead
    safety violation, across the process boundary under procs (the
    threads executor runs the guard in grouped rounds)."""
    p = _port()
    sched = grouped(p, "lookahead", max_workers=2)
    sched.executor_spec = executor
    eng = p.core.Engine(scheduler=sched)
    victim = eng.register(p.CountAll("v"))
    victim.schedule("tick", 100)
    rogue = eng.register(p.RogueDispatcher("r", victim))
    conn = eng.register(p.core.Connection("c", latency_s=1e-6))
    conn.plug(rogue.port("x")).plug(victim.port("x"))
    rogue.start()
    with pytest.raises(RuntimeError, match="lookahead safety violation"):
        eng.run()


def _echo(pair):  # pragma: no cover - runs in the forked child
    import os
    try:
        while True:
            msg = pair.req.recv_bytes()
            if not msg:
                break
            pair.rsp.send_bytes(msg)
    except BaseException:
        os._exit(3)
    os._exit(0)


@case
def ring_stress(executor="procs", with_ref=True, frames=3000, cap=256):
    """Two processes exchange ``frames`` frames of 1 to 3 x ``cap`` bytes
    over a ``cap``-byte ring pair, so every frame streams through the
    ring in chunks and each side publishes its counter many times a
    frame.  The reference's ring, which publishes with
    ``struct.pack_into``, loses its echo child to ``struct.error`` under
    this load; the port's must echo every frame."""
    import multiprocessing
    import random
    rings = _port().rings
    pair = rings.RingPair(capacity=cap)
    proc = multiprocessing.get_context("fork").Process(
        target=_echo, args=(pair,), daemon=True)
    proc.start()

    def deadcheck():
        if not proc.is_alive():
            raise rings.PeerGone(f"echo child exited {proc.exitcode}")

    pair.req.deadcheck = pair.rsp.deadcheck = deadcheck
    rng = random.Random(0)
    try:
        for i in range(frames):
            msg = bytes([i % 251]) * rng.randint(1, 3 * cap)
            pair.req.send_bytes(msg)
            assert pair.rsp.recv_bytes() == msg, i
        pair.req.send_bytes(b"")
        proc.join(timeout=30)
        assert proc.exitcode == 0
    finally:
        if proc.is_alive():
            proc.terminate()
        pair.close()
        pair.unlink()


@case
def simulate_keyword(kw_items, with_ref=True):
    """tests/test_torch_core.py's ``procs`` case: ``simulate(**kw)`` of
    its ring cost on the port equals the port's serial run and the
    reference's."""
    def go(ns, **kw):
        return ns.core.simulate(
            cost=ring_cost(ns), spec=ns.core.SystemSpec(pod_shape=(2, 4)),
            device_limit=None, **kw).summary()
    oracle = go(_port())
    assert go(_port(), **dict(kw_items)) == oracle
    if with_ref:
        assert go(_ref()) == oracle


# ---------------------------------------------------------------------------
# the what-ifs (tests/test_sim_system.py)
# ---------------------------------------------------------------------------

def _what_if_kw(ns):
    return dict(cost=ring_cost(ns, n_devices=8, layers=4),
                spec=ns.core.SystemSpec(pod_shape=(2, 4), num_pods=1))


@case
def what_if_failure(sched, executor, with_ref=True):
    def go(ns, **kw):
        a = _what_if_kw(ns)
        return ns.core.what_if_failure(a["cost"], a["spec"], device=2,
                                       deadline_s=0.001, device_limit=None,
                                       **kw)
    oracle = go(_port())
    rep = go(_port(), scheduler=sched, executor=executor, max_workers=2)
    assert rep.summary() == oracle.summary()
    assert rep.collective_timeouts >= 1 and rep.devices_aborted >= 1
    if with_ref:
        assert go(_ref()).summary() == oracle.summary()


@case
def what_if_straggler(sched, executor, with_ref=True):
    def go(ns, **kw):
        a = _what_if_kw(ns)
        return [r.summary() for r in ns.core.what_if_straggler(
            a["cost"], a["spec"], device=3, slow_factor=4.0,
            device_limit=None, **kw)]
    oracle = go(_port())
    assert go(_port(), scheduler=sched, executor=executor,
              max_workers=2) == oracle
    if with_ref:
        assert go(_ref()) == oracle


# ---------------------------------------------------------------------------
# the event fabric (tests/test_fabric.py)
# ---------------------------------------------------------------------------

def _mixed(layers):
    def kw(ns):
        H = ns.hlo
        cost = H.HloCost()
        groups = [list(range(8))]
        for i in range(layers):
            cost.trace.append(H.TraceOp("compute", f"seg{i}", flops=1e9,
                                        hbm_bytes=1e6))
            rec = H.CollectiveRecord("all-reduce", f"ar{i}", 1e6, int(1e6),
                                     int(1e6), groups)
            cost.collectives.append(rec)
            cost.trace.append(H.TraceOp("collective", f"ar{i}",
                                        collective=rec))
        return dict(cost=cost, spec=ns.core.SystemSpec(pod_shape=(4, 4),
                                                       num_pods=2),
                    device_limit=None, fabric="event")
    return kw


@case
def event_fabric_across_schedulers(sched, executor, with_ref=True):
    oracle, rep = _sim_same(_mixed(3), sched, executor, with_ref)
    assert rep.link_utilization == oracle.link_utilization
    assert rep.events == oracle.events


@case
def event_fabric_congestion_and_faults(sched, executor, with_ref=True):
    oracle, rep = _sim_same(
        _mixed(4), sched, executor, with_ref,
        faults={"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 4.0)]})
    assert rep.link_utilization == oracle.link_utilization


# ---------------------------------------------------------------------------
# the serving simulator (tests/test_serve_sim.py, test_serve_failover.py)
# ---------------------------------------------------------------------------

DEADLINE = 5e-4
KILL = {"chip1.prog": [(3e-3, "fail", None)]}
SECOND_KILL = {"chip1.prog": [(3e-3, "fail", None)],
               "chip2.prog": [(3.4e-3, "fail", None)]}
STRAGGLER_LINK = {"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 32.0)]}
SPECS = {"small": dict(pod_shape=(2, 2)),
         "wide": dict(pod_shape=(2, 2), num_pods=2),
         "tiny": dict(pod_shape=(2, 1)),
         "one": dict(pod_shape=(1, 1))}
_serial: dict = {}


def serve_run(ns, spec, scen_kw, run_kw, sched=None, executor=None):
    """run_serving of build_scenario(spec, seed=3, 800 rps, 6 ms,
    **scen_kw) on ``ns``; serial runs are cached by their arguments.
    ``scen_kw`` may hold a ``model`` name: that config of ``ns``."""
    sim = serve_sim(ns)
    key = (ns.name, spec, repr(sorted(scen_kw.items())),
           repr(sorted(run_kw.items())))
    if sched is None and key in _serial:
        return _serial[key]
    s = ns.core.SystemSpec(**SPECS[spec])
    kw = dict(rate_rps=800.0, duration_s=0.006, seed=3)
    kw.update(scen_kw)
    if "model" in kw:
        kw["model"] = importlib.import_module(
            f"{ns.name}.models").get_config(kw["model"])
    scen = sim.build_scenario(s, **kw)
    assert scen is not None
    extra = {} if sched is None else dict(scheduler=sched, executor=executor,
                                          max_workers=2)
    rep = sim.run_serving(scen, spec=s, **run_kw, **extra)
    if sched is None:
        _serial[key] = rep
    return rep


def _serve_same(sched, executor, with_ref, spec, scen_kw, run_kw):
    oracle = serve_run(_port(), spec, scen_kw, run_kw)
    rep = serve_run(_port(), spec, scen_kw, run_kw, sched, executor)
    assert rep.summary() == oracle.summary()
    assert rep.scheduler == sched and rep.executor == executor
    if with_ref:
        assert serve_run(_ref(), spec, scen_kw, run_kw).summary() == \
            oracle.summary()
    return oracle, rep


@case
def serving_identity(sched, executor, fabric, with_ref=True):
    _serve_same(sched, executor, with_ref, "small", {}, dict(fabric=fabric))


@case
def serving_identity_under_fault(sched, executor, with_ref=True):
    oracle, _ = _serve_same(sched, executor, with_ref, "small", {},
                            dict(fabric="event", faults=STRAGGLER_LINK))
    healthy = serve_run(_port(), "small", {}, dict(fabric="event"))
    assert oracle.summary() != healthy.summary()


@case
def recovery_identity(sched, executor, fabric, with_ref=True):
    oracle, rep = _serve_same(sched, executor, with_ref, "small", {},
                              dict(fabric=fabric, deadline_s=DEADLINE,
                                   recovery=True, faults=KILL))
    assert rep.retries == oracle.retries > 0


@case
def second_failure_identity(sched, executor, fabric, with_ref=True):
    _serve_same(sched, executor, with_ref, "small", dict(tenants=1),
                dict(fabric=fabric, deadline_s=DEADLINE, recovery=True,
                     faults=SECOND_KILL))


@case
def spare_failover_identity(sched, executor, fabric, with_ref=True):
    _serve_same(sched, executor, with_ref, "wide", dict(spares=1),
                dict(fabric=fabric, deadline_s=DEADLINE, recovery=True,
                     faults=KILL))


# ---------------------------------------------------------------------------
# the case lists of each test file: (case id, case name, args)
# ---------------------------------------------------------------------------

def _ids(name, *axes):
    """Every combination of ``axes`` for ``CASES[name]``."""
    combos = [()]
    for axis in axes:
        combos = [c + (v,) for c in combos for v in axis]
    return [("-".join((name,) + c), name, list(c)) for c in combos]


def engine_cases(executor):
    ex = (executor,)
    out = (_ids("describe_reports_executor", ex)
           + _ids("divergent_trace", SCHEDS, ex)
           + _ids("event_fabric_replay", ex)
           + _ids("analytic_link_report", ex)
           + _ids("fault_injection", ex)
           + _ids("transient_fault", SCHEDS, ex)
           + _ids("engine_rerun", ex)
           + _ids("partial_run_then_resume", ex)
           + _ids("blob_payloads_three_workers", ex)
           + _ids("hook_state_not_double_counted", ex)
           + _ids("component_hook_merges_back", ex)
           + _ids("limited_connection_backpressure", ex)
           + _ids("strict_window_guard", ex)
           + _ids("what_if_failure", SCHEDS, ex)
           + _ids("what_if_straggler", ("batch", "bounded"), ex))
    if executor == "procs":
        out += (_ids("procs_clamps_idle_workers", ex)
                + _ids("ring_stress", ex) + _ids("worker_crash_raises", ex)
                + _ids("worker_exception_propagates", ex))
    return out


def fabric_cases(executor):
    ex = (executor,)
    return (_ids("event_fabric_across_schedulers", SCHEDS, ex)
            + _ids("event_fabric_congestion_and_faults", SCHEDS, ex))


def serve_cases(executor):
    ex, fabrics = (executor,), ("analytic", "event")
    return (_ids("serving_identity", SCHEDS, ex, fabrics)
            + _ids("serving_identity_under_fault", SCHEDS, ex)
            + _ids("recovery_identity", SCHEDS, ex, fabrics)
            + _ids("second_failure_identity", SCHEDS, ex, fabrics)
            + _ids("spare_failover_identity", SCHEDS, ex, fabrics))
