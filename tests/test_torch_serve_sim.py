"""repro_torch's serving simulator against the reference's (CPU): the
cases of tests/test_serve_sim.py and tests/test_serve_failover.py.

Every run is made on both packages from the same arguments and held
with ``==`` on ``ServeReport.summary()`` (white-box cases: on every
request record), besides the reference test's own checks on the port.
The scheduler x executor x fabric matrix runs here on ``threads``, with
the port's serial run held to the reference's, and on ``procs`` in one
fresh interpreter that imports neither JAX nor ``repro.serve``
(``_torch_sim_nodes.run_in_child``), held to the port's serial run."""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from _torch_sim_cases import (CASES, DEADLINE, KILL, SECOND_KILL,  # noqa
                              STRAGGLER_LINK, serve_cases, serve_run)
from _torch_sim_nodes import pkg, run_in_child, serve_sim  # noqa: E402

P, J = pkg("repro_torch"), pkg("repro")
PS, JS = serve_sim(P), serve_sim(J)
REJOIN = {"chip1.prog": [(2e-3, "fail", None), (4e-3, "recover", None)]}


def _both(spec="small", scen_kw=None, **run_kw):
    """The port's serial report, after holding its summary to the
    reference's."""
    got = serve_run(P, spec, scen_kw or {}, run_kw)
    want = serve_run(J, spec, scen_kw or {}, run_kw)
    assert got.summary() == want.summary()
    return got


def _rec(r):
    """A request record's fields (the record class has slots)."""
    return {k: getattr(r, k) for k in r.__slots__}


def _small(ns):
    return ns.core.SystemSpec(pod_shape=(2, 2))


def _scenario(ns, spec=None, **kw):
    kw = {**dict(rate_rps=800.0, duration_s=0.006, seed=3), **kw}
    scen = serve_sim(ns).build_scenario(spec or _small(ns), **kw)
    assert scen is not None
    return scen


# -- arrival generators ------------------------------------------------------

def test_generator_registry_matches_reference():
    assert sorted(PS.GENERATORS) == sorted(JS.GENERATORS)


@pytest.mark.parametrize("name", sorted(PS.GENERATORS))
def test_generator_deterministic_and_ordered(name):
    gen = PS.GENERATORS[name]
    a = gen(500.0, 0.1, seed=7)
    assert np.array_equal(a, JS.GENERATORS[name](500.0, 0.1, seed=7))
    assert np.array_equal(a, gen(500.0, 0.1, seed=7))
    assert not np.array_equal(a, gen(500.0, 0.1, seed=8))
    assert len(a) > 0
    assert np.all(np.diff(a) > 0)
    assert 0.0 < a[0] and a[-1] < 0.1


def test_poisson_mean_interarrival_bound():
    t = PS.GENERATORS["poisson"](1000.0, 2.0, seed=0)
    assert 0.8e-3 < np.diff(t).mean() < 1.25e-3


def test_bursty_rate_between_states():
    t = PS.GENERATORS["bursty"](1000.0, 2.0, seed=0)
    assert 1000.0 * 2.0 / 4.5 < len(t) < 1000.0 * 2.0 * 4.5
    gaps = np.diff(t)
    assert gaps.var() / gaps.mean() ** 2 > 1.2


def test_diurnal_rate_bounds_and_modulation():
    rate, dur = 1000.0, 2.0
    t = PS.GENERATORS["diurnal"](rate, dur, seed=0, depth=0.8, period_s=dur)
    assert np.array_equal(t, JS.GENERATORS["diurnal"](
        rate, dur, seed=0, depth=0.8, period_s=dur))
    assert 0.5 * rate * dur < len(t) < 1.5 * rate * dur
    assert (t < dur / 2).sum() > 1.3 * (t >= dur / 2).sum()


def test_make_requests_equal_reference_and_ranged():
    times = PS.GENERATORS["poisson"](500.0, 0.05, seed=1)
    a = PS.make_requests(times, seed=2, prompt_range=(8, 16),
                         decode_range=(2, 5))
    want = JS.make_requests(times, seed=2, prompt_range=(8, 16),
                            decode_range=(2, 5))
    assert [dataclasses.astuple(r) for r in a] == \
        [dataclasses.astuple(r) for r in want]
    assert all(8 <= r.prompt_len <= 16 for r in a)
    assert all(2 <= r.decode_len <= 5 for r in a)
    assert [r.uid for r in a] == list(range(len(a)))
    assert PS.make_requests(times, seed=3)[0] != a[0]


def test_unknown_generator_rejected():
    with pytest.raises(ValueError, match="unknown arrival generator"):
        PS.build_scenario(_small(P), arrival="lognormal")


# -- the slot ledger ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_random_interleaving_invariants(seed):
    trail = []
    for sim in (PS, JS):
        rng = np.random.default_rng(seed)
        led = sim.SlotLedger(capacity=4)
        waiting, seated, slots = list(range(60)), [], []
        while waiting or seated:
            if seated and (not waiting or not led.has_free()
                           or rng.uniform() < 0.5):
                uid = seated.pop(rng.integers(len(seated)))
                slots.append(led.release(uid))
            else:
                uid = waiting.pop(0)
                slots.append(led.admit(uid))
                seated.append(uid)
            assert led.in_use <= led.capacity
            assert led.in_use == len(seated)
        assert led.completed == set(range(60))
        assert led.peak <= 4 and led.in_use == 0
        trail.append(slots)
    assert trail[0] == trail[1]


def test_ledger_rejects_misuse():
    led = PS.SlotLedger(2)
    led.admit(0)
    with pytest.raises(ValueError, match="already seated"):
        led.admit(0)
    led.admit(1)
    with pytest.raises(RuntimeError, match="no free slot"):
        led.admit(2)
    led.release(0)
    with pytest.raises(ValueError, match="already completed"):
        led.admit(0)
    with pytest.raises(ValueError, match="double-completed"):
        led.release(0)
    with pytest.raises(ValueError, match="not seated"):
        led.release(9)
    with pytest.raises(ValueError, match="capacity"):
        PS.SlotLedger(0)


def test_ledger_lowest_free_slot_first_and_evict():
    led = PS.SlotLedger(3)
    assert [led.admit(u) for u in (10, 11, 12)] == [0, 1, 2]
    led.release(11)
    led.release(10)
    assert led.admit(13) == 0
    led = PS.SlotLedger(2)
    led.admit(7)
    led.admit(8)
    assert led.evict(7) == 0
    assert led.in_use == 1 and 7 not in led.completed
    assert led.admit(7) == 0
    led.release(7)
    with pytest.raises(ValueError, match="already completed"):
        led.evict(7)
    with pytest.raises(ValueError, match="not seated"):
        led.evict(9)
    assert led.evict(8) == 1 and led.in_use == 0


def test_ledger_hypothesis_capacity_and_conservation():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(cap=st.integers(1, 8),
               actions=st.lists(st.tuples(st.booleans(), st.integers(0, 63)),
                                max_size=120))
    def run(cap, actions):
        led, ref = PS.SlotLedger(cap), JS.SlotLedger(cap)
        seated: set = set()
        for admit, pick in actions:
            if admit and led.has_free():
                uid = next((u for u in range(64)
                            if u not in seated and u not in led.completed),
                           None)
                if uid is None:
                    continue
                assert led.admit(uid) == ref.admit(uid)
                seated.add(uid)
            elif seated:
                uid = sorted(seated)[pick % len(seated)]
                assert led.release(uid) == ref.release(uid)
                seated.remove(uid)
            assert led.in_use <= cap
            assert led.in_use + len(led.free) == cap
            assert set(led.seated) == seated
            assert not (seated & led.completed)

    run()


def test_ledger_hypothesis_queue_plus_service_is_e2e():
    """The port's request records keep integer-ps stamps, so the
    breakdown reconstructs end-to-end latency with zero residue."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=100, deadline=None)
    @hyp.given(arrival=st.integers(0, 10**15), queue=st.integers(0, 10**12),
               prefill=st.integers(1, 10**12), decode=st.integers(0, 10**12))
    def run(arrival, queue, prefill, decode):
        admit = arrival + queue
        first = admit + prefill
        done = first + decode
        assert (admit - arrival) + (first - admit) + (done - first) \
            == done - arrival
        assert float(done - arrival) / 1e12 == (done - arrival) / 1e12

    run()


# -- scenarios and sizing ----------------------------------------------------

def test_build_scenario_places_disjoint_row_blocks():
    scen = _scenario(P)
    assert [t.devices for t in scen.tenants] == [(0, 1), (2, 3)]
    assert PS.build_scenario(_small(P), tenants=3) is None
    big = PS.build_scenario(P.core.SystemSpec(pod_shape=(4, 4)), tenants=2)
    assert [t.devices for t in big.tenants] == [
        tuple(range(0, 8)), tuple(range(8, 16))]


def test_overlapping_or_out_of_range_tenants_rejected():
    t0 = _scenario(P).tenants[0]
    with pytest.raises(ValueError, match="two tenants"):
        PS.ServingSystem(PS.ServingScenario("bad", (t0, t0)), _small(P))
    off = dataclasses.replace(t0, devices=(0, 99))
    with pytest.raises(ValueError, match="outside"):
        PS.ServingSystem(PS.ServingScenario("bad", (off,)), _small(P))


@pytest.mark.parametrize("model", [None, "qwen2-1.5b", "mamba2-1.3b"])
def test_sizing_is_exact_and_equals_reference(model):
    """ServeSizing from the port's ModelConfig (the default dense model,
    and the two configs the port serves) equals the reference's."""
    def tenant(ns):
        kw = {}
        if model:
            kw["model"] = importlib.import_module(
                f"{ns.name}.models").get_config(model)
        return _scenario(ns, **kw).tenants[0]
    tp, tj = tenant(P), tenant(J)
    s, r = PS.ServeSizing(tp), JS.ServeSizing(tj)
    assert vars(s) == vars(r)
    for b in range(1, tp.slots + 1):
        assert isinstance(s.ar_bytes(b), int)
        assert s.ar_bytes(b) == b * s.ar_bytes(1) == r.ar_bytes(b)
        assert s.a2a_bytes(b) == r.a2a_bytes(b)
        assert s.decode_flops(b) == r.decode_flops(b)
        assert s.decode_hbm(b) == r.decode_hbm(b)
    assert s.prefill_flops(32) == 2 * s.prefill_flops(16)
    assert s.kv_bytes(1000) == r.kv_bytes(1000)


def test_full_width_qwen2_tenant_serves_like_the_reference():
    """One tenant of the port's full qwen2-1.5b config on one chip:
    ``build_scenario`` takes the port's ModelConfig where the reference
    takes its own, and the two serve alike."""
    rep = _both("one", dict(model="qwen2-1.5b", tenants=1, slots=4,
                             prompt_range=(64, 1000), decode_range=(32, 32)))
    assert rep.completed == rep.offered > 0
    assert rep.devices == 1


# -- serving runs ------------------------------------------------------------

def test_latency_breakdown_sums_exactly():
    recs = []
    for ns in (P, J):
        sys_ = serve_sim(ns).ServingSystem(_scenario(ns), _small(ns))
        sys_.run()
        recs.append([_rec(rec) for server in sys_.servers
                     for rec in server.recs.values()])
    assert recs[0] == recs[1]
    for rec in recs[0]:
        assert rec["done_ps"] is not None
        q = rec["admit_ps"] - rec["arrival_ps"]
        p = rec["first_ps"] - rec["admit_ps"]
        d = rec["done_ps"] - rec["first_ps"]
        assert q >= 0 and p > 0 and d >= 0
        assert q + p + d == rec["done_ps"] - rec["arrival_ps"]
    assert len(recs[0]) == sum(len(t.requests) for t in _scenario(P).tenants)


def test_report_counts_and_goodput():
    rep = _both()
    assert rep.offered == rep.completed + rep.in_flight + rep.queued
    assert rep.completed == rep.offered
    assert rep.goodput_rps > 0 and rep.offered_rps > 0
    assert rep.p50_s <= rep.p99_s <= rep.max_s
    assert all(1 <= p <= 4 for p in rep.peak_slots)
    assert rep.devices == 4 and rep.tenants == 2
    assert len(rep.tenant_p99_s) == 2
    s = rep.summary()
    assert "scheduler" not in s and "executor" not in s
    assert "p99_s" in s and "per_request" in s


def test_slots_cap_batch_and_queueing_appears_under_overload():
    calm = _both(scen_kw=dict(seed=5, rate_rps=300.0, slots=2))
    slam = _both(scen_kw=dict(seed=5, rate_rps=4000.0, slots=2))
    assert all(p <= 2 for p in slam.peak_slots)
    assert max(slam.peak_slots) == 2
    assert slam.queue_mean_s > calm.queue_mean_s
    assert slam.p99_s > calm.p99_s


def test_collective_count_matches_iterations():
    dense = _both()
    assert dense.collectives_completed == dense.iterations * 4
    moe = _both(scen_kw=dict(moe=True))
    assert moe.collectives_completed == moe.iterations * 6
    assert moe.summary() != dense.summary()


def test_straggler_link_raises_event_p99():
    healthy = _both(fabric="event")
    faulted = _both(fabric="event", faults=STRAGGLER_LINK)
    assert faulted.p99_s > healthy.p99_s
    assert faulted.tenant_p99_s[0] > healthy.tenant_p99_s[0]
    assert faulted.tenant_p99_s[1] == healthy.tenant_p99_s[1]
    assert faulted.completed == healthy.completed


def test_analytic_run_rejects_link_plans():
    with pytest.raises(ValueError, match="require fabric='event'"):
        PS.run_serving(_scenario(P), spec=_small(P), fabric="analytic",
                       faults=STRAGGLER_LINK)


def test_transient_link_stalls_only_the_affected_tenant():
    rep = _both(fabric="event", faults={
        "fabric.pod0.ici[0,1]+x": [(1e-3, "transient", 1e-3)]})
    healthy = _both(fabric="event")
    assert rep.completed < healthy.completed
    assert rep.in_flight + rep.queued > 0
    assert rep.tenant_p99_s[1] == healthy.tenant_p99_s[1]


def test_chip_straggler_degrades_analytic():
    healthy = _both()
    slow = _both(faults={"chip0.core": [(0.0, "slow", 4.0)]})
    assert slow.tenant_p99_s[0] > healthy.tenant_p99_s[0]
    assert slow.mean_s > healthy.mean_s


# -- recovery: detection, abort, re-mesh, requeue ----------------------------

def test_recovery_serves_through_chip_kill():
    rep = _both(deadline_s=DEADLINE, recovery=True, faults=KILL)
    assert rep.offered == rep.completed + rep.dropped
    assert rep.retries > 0 and rep.recoveries >= 1
    assert rep.chip_deaths == 1 and rep.collective_timeouts >= 1
    assert rep.tenant_availability[0] < 1.0
    assert rep.tenant_availability[1] == 1.0
    assert rep.tenant_outage_s[0] > 0 and rep.tenant_outage_s[1] == 0
    assert rep.outage_windows[0] and not rep.outage_windows[1]
    assert rep.goodput_in_outage_rps < rep.goodput_outside_outage_rps


def test_recovery_cross_fabric_behavioral_identity():
    a = _both(deadline_s=DEADLINE, recovery=True, faults=KILL).summary()
    e = _both(fabric="event", deadline_s=DEADLINE, recovery=True,
              faults=KILL).summary()
    skip = ("events", "fabric", "link_report", "link_utilization")
    assert {k: v for k, v in a.items() if k not in skip} \
        == {k: v for k, v in e.items() if k not in skip}


def test_rejoin_rolls_the_chip_back_in():
    rep = _both(deadline_s=DEADLINE, recovery=True, faults=REJOIN)
    assert rep.rejoins == 1 and rep.chip_deaths == 1
    assert rep.completed == rep.offered
    assert rep.retries > 0 and rep.dropped == 0


def test_transient_link_served_through_with_recovery():
    rep = _both(fabric="event", deadline_s=DEADLINE, recovery=True,
                faults={"fabric.pod0.ici[0,1]+x": [(1e-3, "transient",
                                                    1e-3)]})
    assert rep.completed == rep.offered
    assert rep.retries >= 1 and rep.recoveries >= 1
    assert rep.chip_deaths == 0


def test_deadline_alone_keeps_a_healthy_run():
    base = _both()
    rep = _both(deadline_s=DEADLINE, recovery=False)
    assert rep.collective_timeouts == 0
    assert rep.p99_s == base.p99_s and rep.completed == base.completed
    assert rep.retries == rep.recoveries == rep.chip_deaths == 0
    stalled = _both(deadline_s=DEADLINE, recovery=False, faults=KILL)
    assert stalled.collective_timeouts >= 1
    assert stalled.completed < stalled.offered
    assert stalled.retries == 0 and stalled.recoveries == 0


def test_heartbeat_detects_death_on_collective_free_tenant():
    rep = _both("tiny", deadline_s=DEADLINE, recovery=True,
                faults={"chip0.prog": [(2e-3, "fail", None)]})
    assert rep.chip_deaths == 1 and rep.collective_timeouts == 0
    assert rep.tenant_availability[0] < 1.0
    assert rep.tenant_availability[1] == 1.0
    assert rep.queued > 0
    assert rep.completed + rep.queued == rep.offered


# -- stateful failover (tests/test_serve_failover.py) ------------------------

def test_backoff_ps_is_capped():
    p = PS.RecoveryPolicy(backoff_base_s=1e-4, backoff_max_s=3e-4)
    r = JS.RecoveryPolicy(backoff_base_s=1e-4, backoff_max_s=3e-4)
    delays = [p.backoff_ps(n) for n in range(1, 8)]
    assert delays == [r.backoff_ps(n) for n in range(1, 8)]
    assert delays[0] == P.core.s_to_ps(1e-4)
    assert delays[1] == P.core.s_to_ps(2e-4)
    assert all(d == P.core.s_to_ps(3e-4) for d in delays[2:])
    unbounded = PS.RecoveryPolicy(backoff_base_s=1e-4, backoff_max_s=None)
    assert unbounded.backoff_ps(10) == P.core.s_to_ps(1e-4 * 2 ** 9)


def _policy_run(spec, scen_kw, policy_kw, faults, until_s=None):
    """run_serving with a RecoveryPolicy built on each package."""
    reps = []
    for ns in (P, J):
        sim = serve_sim(ns)
        s = ns.core.SystemSpec(**{"small": dict(pod_shape=(2, 2)),
                                  "wide": dict(pod_shape=(2, 2),
                                               num_pods=2)}[spec])
        reps.append(sim.run_serving(
            _scenario(ns, s, **scen_kw), spec=s, deadline_s=DEADLINE,
            recovery=sim.RecoveryPolicy(**policy_kw), faults=faults,
            until_s=until_s))
    assert reps[0].summary() == reps[1].summary()
    return reps[0]


def test_high_retry_requests_still_land_under_cap():
    rep = _policy_run("small", dict(tenants=1),
                      dict(max_retries=16, backoff_base_s=3e-4,
                           backoff_max_s=6e-4),
                      {"chip1.prog": [(2e-3, "fail", None)],
                       "chip2.prog": [(3e-3, "fail", None)]})
    assert rep.chip_deaths == 2
    assert rep.dropped == 0
    assert rep.completed == rep.offered
    assert rep.in_flight == 0 and rep.queued == 0


def _white_box(ns, spec, scen_kw, faults):
    """tests/test_serve_failover.py's ``_run_system`` on ``ns``."""
    sim = serve_sim(ns)
    system = sim.ServingSystem(_scenario(ns, spec, **scen_kw), spec,
                               deadline_s=DEADLINE,
                               recovery=sim.RecoveryPolicy())
    plan = {name: [(ns.core.s_to_ps(t), a, arg) for (t, a, arg) in acts]
            for name, acts in faults.items()}
    targets = (system.cores + system.programs + system.servers
               + system.fabric.fault_targets())
    inj = ns.hooks.FaultInjector(plan)
    for comp in targets:
        comp.accept_hook(inj)
    inj.arm(targets)
    system.note_failover_plans(sim._fault_candidates(faults))
    system.run()
    return system


def _white_box_both(scen_kw, faults):
    got, want = (_white_box(ns, _small(ns), scen_kw, faults)
                 for ns in (P, J))
    assert [_rec(r) for r in got.servers[0].recs.values()] == \
        [_rec(r) for r in want.servers[0].recs.values()]
    return got.servers[0]


def test_simultaneous_verdicts_do_not_double_penalize():
    server = _white_box_both(dict(tenants=1),
                             {"chip1.prog": [(3e-3, "fail", None)],
                              "chip2.prog": [(3e-3, "fail", None)]})
    assert len(server.dead) == 2
    for rec in server.recs.values():
        assert rec.done_ps is not None or rec.dropped_ps is not None
        assert rec.retries <= 1


def test_migration_saves_prefill_and_breakdown_stays_exact():
    server = _white_box_both(dict(tenants=1), KILL)
    assert server.prefill_saved_tokens > 0
    assert server.prefill_recompute_tokens > 0
    assert server.migrated_bytes > 0
    for rec in server.recs.values():
        if rec.done_ps is None:
            continue
        q = rec.admit_ps - rec.arrival_ps
        p = rec.first_ps - rec.admit_ps
        d = rec.done_ps - rec.first_ps
        assert q >= 0 and p > 0 and d >= 0
        assert q + p + d == rec.done_ps - rec.arrival_ps


def test_second_failure_during_recovery_no_stuck_requests():
    rep = _both(scen_kw=dict(tenants=1), deadline_s=DEADLINE, recovery=True,
                faults=SECOND_KILL)
    assert rep.chip_deaths == 2
    assert rep.completed + rep.dropped == rep.offered
    assert rep.in_flight == 0 and rep.queued == 0


def test_spare_requires_policy():
    with pytest.raises(ValueError):
        PS.ServingSystem(_scenario(P, P.core.SystemSpec(
            pod_shape=(2, 2), num_pods=2), spares=1),
            P.core.SystemSpec(pod_shape=(2, 2), num_pods=2))


def test_spare_claim_restores_capacity_and_availability():
    no_spare = _both("wide", deadline_s=DEADLINE, recovery=True, faults=KILL)
    spare = _both("wide", dict(spares=1), deadline_s=DEADLINE, recovery=True,
                  faults=KILL)
    assert spare.chip_deaths == 1
    assert spare.spare_claims == 1 and spare.spare_returns == 0
    assert no_spare.spare_claims == 0
    assert (spare.tenant_effective_availability[0]
            > no_spare.tenant_effective_availability[0])
    assert spare.tenant_effective_availability[1] == 1.0
    assert spare.completed == spare.offered
    assert spare.migrated_bytes > 0


def test_spare_returned_on_rejoin():
    rep = _both("wide", dict(spares=1), deadline_s=DEADLINE, recovery=True,
                faults=REJOIN)
    assert rep.chip_deaths == 1 and rep.rejoins == 1
    assert rep.spare_claims == 1 and rep.spare_returns == 1
    assert rep.completed == rep.offered
    assert rep.in_flight == 0 and rep.queued == 0


def test_killing_the_claimed_spare_still_drains():
    rep = _both("wide", dict(spares=1, tenants=1), deadline_s=DEADLINE,
                recovery=True,
                faults={"chip1.prog": [(3e-3, "fail", None)],
                        "chip4.prog": [(4.2e-3, "fail", None)]})
    assert rep.chip_deaths == 2
    assert rep.spare_claims >= 1
    assert rep.completed + rep.dropped == rep.offered
    assert rep.in_flight == 0 and rep.queued == 0


def test_migration_traffic_visible_in_fabric_report():
    rep = _both(scen_kw=dict(tenants=1), deadline_s=DEADLINE, recovery=True,
                faults=KILL)
    healthy = _both(scen_kw=dict(tenants=1))
    assert rep.migrated_bytes > 0
    assert rep.fabric_traffic.get("all-to-all", 0) > 0
    assert healthy.fabric_traffic.get("all-to-all", 0) == 0
    base = _both()
    assert base.prefill_saved_tokens == 0
    assert base.migrated_bytes == 0 and base.spare_claims == 0
    assert base.completed == base.offered


def test_quorum_unreachable_keeps_suspect_alive():
    rep = _policy_run("small", {}, dict(quorum=3, max_retries=2), KILL,
                      until_s=0.012)
    assert rep.chip_deaths == 0
    assert rep.collective_timeouts >= 1
    assert rep.dropped > 0


@pytest.mark.parametrize("scen_kw,policy_kw", [
    ({}, dict(quorum=2)), (dict(tenants=1), {})],
    ids=["quorum_reachable", "default_quorum_is_peer_majority"])
def test_quorum_fences_the_chip(scen_kw, policy_kw):
    rep = _policy_run("small", scen_kw, policy_kw, KILL)
    assert rep.chip_deaths == 1
    assert rep.completed + rep.dropped == rep.offered


def test_slow_quorum_still_reconciles_unseated_checkpoints():
    rep = _policy_run("wide", dict(rate_rps=600.0, duration_s=0.02, seed=11,
                                   spares=1),
                      dict(quorum=2), {"chip1.prog": [(5e-3, "fail", None)]})
    assert rep.chip_deaths == 1 and rep.spare_claims == 1
    assert rep.prefill_recompute_tokens > 0
    assert rep.migrated_bytes > 0
    assert rep.completed + rep.dropped == rep.offered


# -- scheduler x executor x fabric -------------------------------------------

THREADS = serve_cases("threads")
PROCS = serve_cases("procs")


@pytest.fixture(scope="module")
def procs_results():
    return run_in_child("_torch_sim_cases", PROCS, with_ref=False)


@pytest.mark.parametrize("name,args", [c[1:] for c in THREADS],
                         ids=[c[0] for c in THREADS])
def test_threads_case(name, args):
    CASES[name](*args, with_ref=True)


@pytest.mark.parametrize("case_id", [c[0] for c in PROCS])
def test_procs_case(case_id, procs_results):
    assert procs_results[case_id] == "ok", procs_results[case_id]
