"""repro_torch's round schedulers and executors against the reference's
(CPU): the cases of tests/test_sim_engine.py and tests/test_executor.py.

Every workload is built code for code on both packages
(``_torch_sim_nodes.pkg``).  Each case holds the port's run under a
round scheduler (and an executor) to the port's serial run with ``==``,
and the port's serial run to the reference's: node signatures, end
time, ``events_processed`` and ``SimReport.summary()``.  The ``procs``
cases run in one fresh interpreter (``run_in_child``): ``procs`` forks,
and this process may already hold JAX's and torch's threads."""
import random
import threading

import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from _torch_sim_cases import CASES, engine_cases  # noqa: E402
from _torch_sim_nodes import (build_jitter, convert_cost, grouped,  # noqa
                              pkg, run_in_child, sched_variant,
                              synthetic_workload)

P, J = pkg("repro_torch"), pkg("repro")
ALL_SCHEDULERS = ("serial", "batch", "lookahead", "bounded")
SCHED_VARIANTS = ("batch", "lookahead", "bounded",
                  "batch-grouped", "lookahead-grouped", "bounded-grouped")


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registries_match_the_reference():
    assert sorted(P.core.SCHEDULERS) == sorted(J.core.SCHEDULERS) \
        == sorted(ALL_SCHEDULERS)
    assert sorted(P.core.EXECUTORS) == sorted(J.core.EXECUTORS) \
        == ["procs", "threads"]
    assert isinstance(P.core.make_executor("threads"), P.core.ThreadExecutor)
    assert isinstance(P.core.make_executor("procs"), P.core.ProcExecutor)
    inst = P.core.ThreadExecutor(max_workers=2)
    assert P.core.make_executor(inst) is inst
    for name in ("batch", "lookahead", "bounded"):
        sched = P.core.make_scheduler(name, executor="procs")
        assert isinstance(sched, P.core.RoundScheduler)
        assert sched.executor_spec == "procs"


def test_unknown_executor_raises():
    with pytest.raises(ValueError, match="unknown executor"):
        P.core.make_executor("gpu")


# ---------------------------------------------------------------------------
# schedulers against serial (tests/test_sim_engine.py)
# ---------------------------------------------------------------------------

def _ticks(ns, scheduler, seed=0, max_workers=4):
    eng = ns.core.Engine(scheduler=scheduler, max_workers=max_workers)
    rng = random.Random(seed)
    comps = [eng.register(ns.Ticker(f"t{i}", [rng.randint(1, 5) * 100
                                              for _ in range(20)]))
             for i in range(8)]
    for c in comps:
        c.start()
    end = eng.run()
    return [(c.name, tuple(c.log)) for c in comps], eng, end


def test_serial_equals_reference_and_batch():
    oracle, eng_s, end_s = _ticks(P, "serial")
    want, eng_r, end_r = _ticks(J, "serial")
    assert oracle == want and end_s == end_r
    assert eng_s.events_processed == eng_r.events_processed == 8 * 20
    assert eng_s.batch_widths == eng_r.batch_widths
    assert _ticks(P, "batch")[0] == oracle


@pytest.mark.parametrize("scheduler", SCHED_VARIANTS)
def test_scheduler_bit_identical_to_serial(scheduler):
    oracle, eng_s, end_s = _ticks(P, "serial")
    got, eng_p, end_p = _ticks(P, sched_variant(P, scheduler))
    want, eng_r, _ = _ticks(J, sched_variant(J, scheduler))
    assert got == oracle == want
    assert end_p == end_s
    assert eng_p.events_processed == eng_s.events_processed \
        == eng_r.events_processed


@pytest.mark.parametrize("scheduler", SCHED_VARIANTS)
def test_scheduler_bit_identical_on_divergent_trace(scheduler):
    oracle, end_s, eng_s = build_jitter(P, "serial", ticks=120)
    got, end_p, eng_p = build_jitter(P, sched_variant(P, scheduler),
                                     ticks=120)
    want, end_r, _ = build_jitter(J, "serial", ticks=120)
    assert got == oracle == want and end_p == end_s == end_r
    assert eng_p.events_processed == eng_s.events_processed


def test_lookahead_window_derived_from_min_latency():
    _, _, eng = build_jitter(P, "lookahead", ticks=120)
    _, _, ref = build_jitter(J, "lookahead", ticks=120)
    assert eng.scheduler.window_ps == ref.scheduler.window_ps \
        == P.core.s_to_ps(4e-9)
    assert max(eng.window_widths) > 8
    assert eng.window_widths == ref.window_widths


def test_cluster_affinity_fuses_components():
    eng = P.core.Engine(scheduler="lookahead")
    a, b, c = (eng.register(P.Sink(n)) for n in "abc")
    a.cluster_affinity = b.cluster_affinity = "island"
    eng.compute_clusters()
    assert a.cluster_id == b.cluster_id
    assert c.cluster_id != a.cluster_id


def test_lookahead_window_on_event_fabric():
    def go(ns):
        spec = ns.core.SystemSpec(pod_shape=(2, 2))
        sys_ = ns.core.System(spec, fabric="event", scheduler="lookahead")
        op = ns.system._RunOp(kind="collective", name="ar",
                              coll_kind="all-reduce", bytes=1e5,
                              group=((0, 1),))
        sys_.load_trace([op], [0, 1])
        res = sys_.run()
        return spec, sys_, res
    spec, sys_, res = go(P)
    _, ref, ref_res = go(J)
    assert res == ref_res and res["devices_done"] == 2
    expect = P.core.s_to_ps(spec.chip.ici_hop_latency_s) // 4
    assert sys_.engine.scheduler.window_ps == expect \
        == ref.engine.scheduler.window_ps
    assert max(sys_.engine.window_widths) > 1
    assert sys_.engine.window_widths == ref.engine.window_widths


def test_lookahead_fuses_stateful_connections():
    eng = P.core.Engine(scheduler="lookahead")
    a, b = eng.register(P.Sink("a")), eng.register(P.Sink("b"))
    link = eng.register(P.core.LinkConnection("l", bandwidth=1e9,
                                              latency_s=1e-6))
    link.plug(a.port("p")).plug(b.port("p"))
    eng.compute_clusters()
    assert a.cluster_id == b.cluster_id == link.cluster_id
    assert eng.min_cross_cluster_latency_ps() is None


def test_lookahead_detects_unsafe_cross_cluster_post():
    eng = P.core.Engine(scheduler=grouped(P, "lookahead"))
    victim = eng.register(P.Ticker("v", [100, 100]))
    rogue = eng.register(P.RogueDispatcher("r", victim))
    conn = eng.register(P.core.Connection("c", latency_s=1e-6))
    conn.plug(rogue.port("x")).plug(victim.port("x"))
    victim.start()
    rogue.start()
    with pytest.raises(RuntimeError, match="lookahead safety violation"):
        eng.run()


def test_legacy_parallel_flag_maps_to_batch():
    with pytest.warns(DeprecationWarning, match="scheduler="):
        eng = P.core.Engine(parallel=True)
    assert eng.scheduler.name == "batch"
    assert P.core.Engine().scheduler.name == "serial"
    with pytest.warns(DeprecationWarning, match="scheduler="):
        sys_ = P.core.System(P.core.SystemSpec(pod_shape=(2, 2)),
                             parallel=True)
    assert sys_.engine.scheduler.name == "batch"


def test_custom_scheduler_instance_accepted():
    eng = P.core.Engine(scheduler=P.core.LookaheadScheduler(
        max_workers=2, lookahead_ps=12345))
    c = eng.register(P.Ticker("t", [100]))
    c.start()
    eng.run()
    assert eng.scheduler.window_ps == 12345
    assert eng.events_processed == 1


def _summaries(ns, cost, spec, **kw):
    return {s: ns.core.simulate(cost=cost, spec=spec, scheduler=s, **kw)
            for s in ALL_SCHEDULERS}


def test_schedulers_identical_on_engine_parallelism_trace():
    reps = _summaries(P, synthetic_workload(P, 16, layers=6),
                      P.core.SystemSpec(pod_shape=(4, 4)), device_limit=None)
    refs = _summaries(J, synthetic_workload(J, 16, layers=6),
                      J.core.SystemSpec(pod_shape=(4, 4)), device_limit=None)
    oracle = reps["serial"]
    for name in ALL_SCHEDULERS:
        rep = reps[name]
        assert rep.summary() == oracle.summary() == refs[name].summary()
        assert rep.time_s == oracle.time_s
        assert rep.events == oracle.events
        assert rep.link_report == oracle.link_report
        assert rep.window_widths == refs[name].window_widths
        assert rep.batch_widths == refs[name].batch_widths
    assert reps["lookahead"].window_widths
    assert len(reps["lookahead"].window_widths) < len(oracle.batch_widths)


def test_schedulers_identical_on_the_ports_traced_loss():
    """The port's own front end: the smoke loss traced by
    ``repro_torch.core.analyze`` replays to one summary under every
    scheduler, and the reference's simulator gives the same summary for
    the same records."""
    from repro_torch.models import api, get_config
    cfg = get_config("qwen2-1.5b-smoke")
    batch = {k: torch.zeros((2, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    cost = P.core.analyze(api.loss, api.init(0, cfg, device="meta"), cfg,
                          batch)
    reps = _summaries(P, cost, P.core.SINGLE_POD, device_limit=1)
    want = J.core.simulate(cost=convert_cost(cost, J), spec=J.core.SINGLE_POD,
                           device_limit=1)
    for name in ALL_SCHEDULERS:
        assert reps[name].summary() == want.summary()
    assert want.time_s > 0 and want.events > 0


# ---------------------------------------------------------------------------
# posting from foreign threads
# ---------------------------------------------------------------------------

def _flood(eng, comps, n_threads, per_thread, spread, base=0):
    start = threading.Barrier(n_threads)

    def flood(tid):
        start.wait()
        for k in range(per_thread):
            eng.post(P.core.Event(
                time=base + (tid * per_thread + k) % spread + 1,
                component=comps[(tid + k) % len(comps)], kind="w"))

    threads = [threading.Thread(target=flood, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def test_post_is_thread_safe_under_contention():
    eng = P.core.Engine(scheduler="serial")
    comps = [eng.register(P.Counter(f"c{i}")) for i in range(4)]
    _flood(eng, comps, 16, 500, 1000)
    assert len(eng.queue) == 16 * 500
    eng.run()
    assert eng.events_processed == 16 * 500
    assert sum(c.handled for c in comps) == 16 * 500


def test_post_foreign_threads_stress_sharded_queue_8_workers():
    eng = P.core.Engine(scheduler="lookahead", max_workers=8)
    comps = [eng.register(P.Counter(f"c{i}")) for i in range(8)]
    comps[0].schedule("warmup", 1)
    eng.run()
    assert isinstance(eng.queue, P.core.ShardedEventQueue)
    base = eng.events_processed
    _flood(eng, comps, 8, 400, 777, base=eng.now)
    assert len(eng.queue) == 8 * 400
    eng.run()
    assert eng.events_processed - base == 8 * 400
    assert sum(c.handled for c in comps) == 8 * 400 + 1


# ---------------------------------------------------------------------------
# same-time ordering regressions, each scheduler against serial
# ---------------------------------------------------------------------------

def _zero_delay(ns, scheduler):
    eng = ns.core.Engine(scheduler=scheduler)
    mixer = eng.register(ns.ZeroDelayMixer("mix"))
    sender = eng.register(ns.SameTimeSender("send", when=100))
    conn = eng.register(ns.core.Connection("c0"))
    conn.plug(sender.port("out")).plug(mixer.port("in"))
    mixer.schedule("tick", 100)
    sender.start()
    eng.run()
    return tuple(mixer.order)


def _delay_zero_chain(ns, scheduler):
    eng = ns.core.Engine(scheduler=scheduler, max_workers=4)
    sink = eng.register(ns.TimedSink("s"))
    a = eng.register(ns.DelayZeroChainer("a", sink))
    c = eng.register(ns.DirectSender("c", sink))
    link = eng.register(ns.core.LinkConnection("l", bandwidth=1e9,
                                               latency_s=1e-6))
    link.plug(a.port("o"))
    link.plug(c.port("o"))
    link.plug(sink.port("in"))
    a.schedule("tick", 100)
    c.schedule("tick", 100)
    eng.run()
    return tuple(sink.log)


def _generation_chain(ns, scheduler):
    eng = ns.core.Engine(scheduler=scheduler)
    chains = [eng.register(ns.ChainStarter(f"c{i}")) for i in range(4)]
    for c in chains:
        c.schedule("tick", 100)
        c.schedule("tick", 300)
    eng.run()
    return [tuple(c.log) for c in chains]


@pytest.mark.parametrize("build", [_zero_delay, _delay_zero_chain,
                                   _generation_chain],
                         ids=["same_time_self_post_vs_cross_post",
                              "delay_zero_chain", "generation_chains"])
@pytest.mark.parametrize("scheduler", SCHED_VARIANTS)
def test_same_time_order_bit_identical(scheduler, build):
    oracle = build(P, "serial")
    assert build(P, sched_variant(P, scheduler)) == oracle
    assert build(J, "serial") == oracle


@pytest.mark.parametrize("scheduler", ALL_SCHEDULERS)
def test_limited_connection_slot_free_before_handling(scheduler):
    eng = P.core.Engine(scheduler=scheduler)
    asker = eng.register(P.Sink("asker"))
    echo = eng.register(P.Echo("echo"))
    conn = eng.register(P.core.LimitedConnection(
        "lim", bandwidth=64e9, latency_s=1e-6, capacity=1))
    conn.plug(asker.port("p")).plug(echo.port("p"))
    asker.port("p").send(P.core.Request(src=asker.port("p"), dst=None,
                                        kind="ask", size_bytes=64))
    eng.run()
    assert echo.reply_ok == [True]
    assert asker.received == 1


@pytest.mark.parametrize("scheduler", ("serial",) + SCHED_VARIANTS)
def test_past_post_rejected_in_every_scheduler(scheduler):
    eng = P.core.Engine(scheduler=sched_variant(P, scheduler))
    p = eng.register(P.PastPoster("p"))
    p.schedule("go", 1000)
    with pytest.raises(AssertionError, match="past"):
        eng.run()


# ---------------------------------------------------------------------------
# scheduler x executor (tests/test_executor.py, tests/test_sim_system.py's
# what-if matrix): threads here, procs in one fresh interpreter
# ---------------------------------------------------------------------------

THREADS = engine_cases("threads")
PROCS = engine_cases("procs")


@pytest.fixture(scope="module")
def procs_results():
    return run_in_child("_torch_sim_cases", PROCS, with_ref=True)


@pytest.mark.parametrize("name,args", [c[1:] for c in THREADS],
                         ids=[c[0] for c in THREADS])
def test_threads_case(name, args):
    CASES[name](*args, with_ref=True)


@pytest.mark.parametrize("case_id", [c[0] for c in PROCS])
def test_procs_case(case_id, procs_results):
    assert procs_results[case_id] == "ok", procs_results[case_id]
