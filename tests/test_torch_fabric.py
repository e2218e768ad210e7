"""repro_torch's event fabric and plan cache against the reference's
(CPU): the cases of tests/test_fabric.py and the plan-cache cases of
tests/test_sweep.py.

Each simulation runs on both packages and is held with ``==`` on
``SimReport.summary()`` (or the system's result dict), besides the
reference test's own checks on the port.  The event fabric's
scheduler x executor cases run here on ``threads`` and in one fresh
interpreter on ``procs`` (``_torch_sim_nodes.run_in_child``).  The plan
cache's one departure is tested last: the port's disk files never match
a reference lookup, nor the reference's a port lookup."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from _torch_sim_cases import CASES, fabric_cases  # noqa: E402
from _torch_sim_nodes import child_env, pkg, run_in_child  # noqa: E402

P, J = pkg("repro_torch"), pkg("repro")


def _spec(ns):
    return ns.core.SystemSpec(pod_shape=(4, 4), num_pods=2)


def _coll_cost(ns, kind, nbytes, group):
    H = ns.hlo
    rec = H.CollectiveRecord(kind, "c", nbytes, int(nbytes), int(nbytes),
                             [group])
    return H.HloCost(collectives=[rec],
                     trace=[H.TraceOp("collective", "c", collective=rec)])


def _sim(ns, kind, nbytes, group, fabric, **kw):
    return ns.core.simulate(cost=_coll_cost(ns, kind, nbytes, group),
                            spec=_spec(ns), device_limit=None, fabric=fabric,
                            **kw)


def _both(kind, nbytes, group, fabric, **kw):
    """The port's report, after holding its summary to the reference's."""
    got = _sim(P, kind, nbytes, group, fabric, **kw)
    want = _sim(J, kind, nbytes, group, fabric, **kw)
    assert got.summary() == want.summary()
    assert got.link_utilization == want.link_utilization
    return got


# -- registry ----------------------------------------------------------------

def test_registry_has_both_backends():
    F = P.fabric
    assert sorted(F.FABRICS) == sorted(J.fabric.FABRICS) \
        == ["analytic", "event"]
    assert isinstance(F.make_fabric("analytic", _spec(P)), F.AnalyticFabric)
    assert isinstance(F.make_fabric("event", _spec(P)), F.EventFabric)


def test_unknown_fabric_raises():
    with pytest.raises(ValueError, match="unknown fabric"):
        P.fabric.make_fabric("quantum", _spec(P))


def test_backend_instance_passes_through_and_is_single_use():
    back = P.fabric.EventFabric(_spec(P))
    assert P.fabric.make_fabric(back, _spec(P)) is back
    P.core.System(_spec(P), fabric=back)
    with pytest.raises(RuntimeError, match="single-use"):
        P.core.System(_spec(P), fabric=back)


def test_fault_plan_unknown_target_raises():
    with pytest.raises(ValueError, match="unknown components"):
        _sim(P, "all-reduce", 1e7, [0, 1, 2, 3], "analytic",
             faults={"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 8.0)]})
    with pytest.raises(ValueError, match="unknown components"):
        _sim(P, "all-reduce", 1e7, [0, 1, 2, 3], "event",
             faults={"chip999.core": [(0.0, "slow", 8.0)]})


def test_register_third_backend():
    class MyFabric(P.fabric.AnalyticFabric):
        name = "mine"
    P.fabric.register_fabric("mine", MyFabric)
    try:
        assert P.fabric.make_fabric("mine", _spec(P)).name == "mine"
    finally:
        del P.fabric.FABRICS["mine"]


def test_spec_fabric_default_is_threaded():
    def go(ns, spec):
        H = ns.hlo
        rec = H.CollectiveRecord("all-reduce", "c", 1e5, int(1e5), int(1e5),
                                 [[0, 1]])
        cost = H.HloCost(collectives=[rec],
                         trace=[H.TraceOp("collective", "c", collective=rec)])
        return ns.core.simulate(cost=cost, spec=spec, device_limit=None)
    for fabric in ("event", "analytic"):
        got = go(P, P.core.SystemSpec(pod_shape=(2, 2), fabric=fabric))
        want = go(J, J.core.SystemSpec(pod_shape=(2, 2), fabric=fabric))
        assert got.fabric == fabric
        assert got.summary() == want.summary()


# -- uncongested parity ------------------------------------------------------

PARITY_CASES = [
    ("all-reduce", 1e7, [0, 1, 2, 3]),
    ("all-gather", 1e7, [0, 1, 2, 3]),
    ("reduce-scatter", 1e7, [0, 4, 8, 12]),
    ("all-reduce", 1e7, list(range(16))),
    ("all-to-all", 1e6, [0, 1, 2, 3]),
    ("all-to-all", 1e6, list(range(16))),
    ("collective-permute", 5e5, [0, 1]),
    ("all-reduce", 1e7, [0, 16]),
    ("all-reduce", 1e7, list(range(32))),
]


@pytest.mark.parametrize("kind,nbytes,group", PARITY_CASES)
def test_event_matches_analytic_uncongested(kind, nbytes, group):
    a = _both(kind, nbytes, group, "analytic")
    e = _both(kind, nbytes, group, "event")
    assert a.time_s > 0
    assert e.time_s == pytest.approx(a.time_s, rel=0.05)


def test_event_reports_fabric_and_utilization():
    rep = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    assert rep.fabric == "event"
    assert rep.link_utilization
    assert all(0.0 < u <= 1.0 for u in rep.link_utilization.values())
    assert rep.link_report["hottest_links"]
    assert _both("all-reduce", 1e7, [0, 1, 2, 3],
                 "analytic").link_utilization == {}


# -- congestion the analytic formulas cannot express -------------------------

def _two_tenant_time(ns, fabric, a, devs_a, b, devs_b):
    sys_ = ns.core.System(_spec(ns), fabric=fabric)
    for (name, kind, nbytes, group), devs in ((a, devs_a), (b, devs_b)):
        sys_.load_trace([ns.system._RunOp(
            kind="collective", name=name, coll_kind=kind, bytes=nbytes,
            group=group)], devs)
    return sys_.run()["time_s"]


def _tenants(fabric, a, devs_a, b, devs_b):
    got = _two_tenant_time(P, fabric, a, devs_a, b, devs_b)
    assert got == _two_tenant_time(J, fabric, a, devs_a, b, devs_b)
    return got


def test_concurrent_crosspod_groups_contend_on_dcn():
    a = ("arA", "all-reduce", 1e7, ((0, 16),))
    b = ("arB", "all-reduce", 1e7, ((1, 17),))
    t_a = _tenants("analytic", a, [0, 16], b, [1, 17])
    t_e = _tenants("event", a, [0, 16], b, [1, 17])
    solo = _both("all-reduce", 1e7, [0, 16], "event").time_s
    assert t_a == pytest.approx(solo, rel=0.01)
    assert t_e > t_a * 1.25
    assert t_e - t_a == pytest.approx(
        1e7 / _spec(P).dcn_bandwidth_per_pod, rel=0.05)


def test_concurrent_block_alltoalls_contend_on_bisection():
    a = ("a2aA", "all-to-all", 4e6, (tuple(range(8)),))
    b = ("a2aB", "all-to-all", 4e6, (tuple(range(8, 16)),))
    t_a = _tenants("analytic", a, list(range(8)), b, list(range(8, 16)))
    t_e = _tenants("event", a, list(range(8)), b, list(range(8, 16)))
    assert t_e > t_a * 1.5


def test_disjoint_rings_do_not_contend():
    a = ("arA", "all-reduce", 1e7, ((0, 1, 2, 3),))
    b = ("arB", "all-reduce", 1e7, ((4, 5, 6, 7),))
    t_e = _tenants("event", a, [0, 1, 2, 3], b, [4, 5, 6, 7])
    solo = _both("all-reduce", 1e7, [0, 1, 2, 3], "event").time_s
    assert t_e == pytest.approx(solo, rel=0.01)


# -- cluster derivation ------------------------------------------------------

def test_event_fabric_forms_per_chip_clusters():
    sys_ = P.core.System(_spec(P), fabric="event", scheduler="lookahead")
    sys_.engine.compute_clusters()
    ref = J.core.System(_spec(J), fabric="event", scheduler="lookahead")
    ref.engine.compute_clusters()
    assert [c.cluster_id for c in sys_.engine._components] == \
        [c.cluster_id for c in ref.engine._components]
    fab = sys_.fabric
    assert sys_.coordinator.cluster_id == fab.controller.cluster_id
    chip0 = {link.cluster_id for link in fab.links
             if link.cluster_affinity == "fabric.chip0"}
    assert chip0 == {fab.dmas[0].cluster_id}
    assert fab.dmas[0].cluster_id != fab.dmas[1].cluster_id
    assert fab.dmas[0].cluster_id != fab.controller.cluster_id
    assert fab.dcn[0].cluster_id not in {d.cluster_id for d in fab.dmas}
    expect = P.core.s_to_ps(_spec(P).chip.ici_hop_latency_s) // 4
    assert fab.legs.floor_ps == expect
    assert sys_.engine.min_cross_cluster_latency_ps() == expect


def test_zero_hop_latency_degrades_to_fused_fabric():
    spec = _spec(P)
    spec = dataclasses.replace(
        spec, chip=dataclasses.replace(spec.chip, ici_hop_latency_s=0.0,
                                       dcn_latency_s=0.0))
    sys_ = P.core.System(spec, fabric="event", scheduler="lookahead")
    sys_.engine.compute_clusters()
    fab = sys_.fabric
    assert fab.legs.floor_ps == 0
    assert fab.dmas[0].cluster_id == fab.controller.cluster_id


# -- straggler links ---------------------------------------------------------

SLOW_01 = {"fabric.pod0.ici[0,1]+x": [(0.0, "slow", 8.0)]}


def test_straggler_link_slows_collective():
    base = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    slow = _both("all-reduce", 1e7, [0, 1, 2, 3], "event", faults=SLOW_01)
    assert slow.time_s > base.time_s * 1.5
    assert slow.devices_done == 4


def test_straggler_link_off_path_is_free():
    base = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    off = _both("all-reduce", 1e7, [0, 1, 2, 3], "event",
                faults={"fabric.pod0.ici[3,3]+y": [(0.0, "slow", 8.0)]})
    assert off.time_s == pytest.approx(base.time_s, rel=1e-9)


def test_straggler_dma_engine_slows_collective():
    base = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    slow = _both("all-reduce", 1e7, [0, 1, 2, 3], "event",
                 faults={"fabric.chip1.dma": [(0.0, "slow", 50.0)]})
    assert slow.time_s > base.time_s * 1.5
    assert slow.devices_done == 4


def test_straggler_link_recovers():
    base = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    rec = _both("all-reduce", 1e7, [0, 1, 2, 3], "event",
                faults={"fabric.pod0.ici[0,1]+x": [
                    (0.0, "slow", 8.0), (base.time_s, "recover", None)]})
    assert base.time_s < rec.time_s


# -- transient link faults stall whole rings ---------------------------------

def _faulted_system(ns, faults, kind, group, nbytes):
    sys_ = ns.core.System(_spec(ns), fabric="event")
    inj = ns.hooks.FaultInjector(faults)
    for comp in sys_.fabric.fault_targets():
        comp.accept_hook(inj)
    op = ns.system._RunOp(kind="collective", name="c", coll_kind=kind,
                          bytes=nbytes, group=(tuple(group),))
    sys_.load_trace([op], list(group))
    return sys_


def test_transient_link_fault_stalls_whole_ring():
    s2p = P.core.s_to_ps
    outage = {"fabric.pod0.ici[0,1]+x":
              [(s2p(10e-6), "transient", s2p(40e-6))]}
    out = []
    for ns in (P, J):
        sys_ = _faulted_system(ns, outage, "all-reduce", [0, 1, 2, 3], 1e7)
        res = sys_.run(until_s=0.005)
        out.append((res, [d.progress() for d in sys_.fabric.dmas[:4]]))
    assert out[0] == out[1]
    res, progress = out[0]
    assert res["devices_done"] == 0
    idx = [i for p in progress for i in p.values()]
    assert len(idx) == 4
    assert max(idx) - min(idx) <= 1
    slow = _both("all-reduce", 1e7, [0, 1, 2, 3], "event",
                 faults={"fabric.pod0.ici[0,1]+x": [
                     (10e-6, "slow", 8.0), (50e-6, "recover", None)]})
    assert slow.devices_done == 4


@pytest.mark.parametrize("kind", ["all-to-all", "collective-permute"])
def test_transient_link_fault_stalls_consumers(kind):
    rep = _both(kind, 4e6, [0, 1, 2, 3], "event", until_s=0.01,
                faults={"fabric.pod0.ici[0,1]+x":
                        [(1e-6, "transient", 20e-6)]})
    assert rep.devices_done == 0
    a = _both(kind, 4e6, [0, 1, 2, 3], "analytic")
    e = _both(kind, 4e6, [0, 1, 2, 3], "event")
    assert abs(e.time_s - a.time_s) <= 1e-12
    if kind == "collective-permute":
        s2p = P.core.s_to_ps
        sys_ = _faulted_system(
            P, {"fabric.pod0.ici[0,1]+x":
                [(s2p(1e-6), "transient", s2p(20e-6))]},
            kind, [0, 1, 2, 3], 4e6)
        sys_.run(until_s=0.01)
        assert sys_.fabric.dmas[2].progress()


def test_transient_fault_plan_at_simulate_level():
    rep = _both("all-reduce", 1e7, [0, 1, 2, 3], "event", until_s=0.01,
                faults={"fabric.pod0.ici[0,1]+x":
                        [(10e-6, "transient", 40e-6)]})
    assert rep.devices_done == 0
    rep2 = _both("all-reduce", 1e7, [0, 1, 2, 3], "event", until_s=0.01,
                 faults={"fabric.chip1.dma": [(0.0, "drop", None)]})
    assert rep2.devices_done == 0


def test_ring_dependency_keeps_healthy_timing():
    a = _both("all-reduce", 1e7, [0, 1, 2, 3], "analytic")
    e = _both("all-reduce", 1e7, [0, 1, 2, 3], "event")
    assert e.time_s == pytest.approx(a.time_s, rel=1e-9)


def test_fault_injector_arms_idle_components():
    """tests/test_sim_system.py: fail-then-recover on a link no transfer
    crosses still runs on schedule (``FaultInjector.arm``)."""
    from _torch_sim_nodes import ring_cost
    idle_link = "fabric.pod0.ici[0,0]-y"
    used_link = "fabric.pod0.ici[0,0]+x"
    plan = [(0.0, "fail", None), (1e-6, "recover", None)]
    reps = []
    for link in (idle_link, used_link):
        got, want = (ns.core.simulate(
            cost=ring_cost(ns, n_devices=4, layers=2),
            spec=ns.core.SystemSpec(pod_shape=(2, 2)), fabric="event",
            device_limit=None, faults={link: plan}) for ns in (P, J))
        assert got.summary() == want.summary()
        reps.append(got)
    assert reps[0].devices_done == 4
    assert reps[1].devices_done + reps[1].devices_aborted == 4
    names = {c.name for c in P.core.System(
        P.core.SystemSpec(pod_shape=(2, 2)), fabric="event"
    ).fabric.fault_targets()}
    assert idle_link in names


# -- scheduler x executor on the event fabric --------------------------------

THREADS = fabric_cases("threads")
PROCS = fabric_cases("procs")


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


# -- the plan cache ----------------------------------------------------------

@pytest.fixture
def clean_plancache():
    for ns in (P, J):
        ns.plancache.clear()
        ns.plancache.reset_stats()
        ns.plancache.configure(None)
    yield
    for ns in (P, J):
        ns.plancache.clear()
        ns.plancache.reset_stats()
        ns.plancache.configure(None)


def _topo(ns, pod=(4, 4)):
    return ns.topology.Topology(ns.core.SystemSpec(pod_shape=pod))


def test_plancache_memory_tier(clean_plancache):
    topo = _topo(P)
    group = list(range(4))
    a = P.plancache.cached_decompose(topo, "all-reduce", 1e6, group)
    b = P.plancache.cached_decompose(topo, "all-reduce", 1e6, group)
    assert a is b
    s = P.plancache.stats()
    assert s["misses"] == 1 and s["hits"] == 1 and s["hit_rate"] == 0.5
    assert a == P.event_fabric.decompose(topo, "all-reduce", 1e6, group)


@pytest.mark.parametrize("kind,group", [
    ("all-reduce", list(range(4))), ("all-gather", list(range(16))),
    ("all-to-all", list(range(16))), ("collective-permute", [0, 1])])
def test_decompose_equals_reference(kind, group):
    """Plans compare field by field: the port's steps hold the same
    numbers as the reference's."""
    got = P.event_fabric.decompose(_topo(P), kind, 1e6, group)
    want = J.event_fabric.decompose(_topo(J), kind, 1e6, group)
    assert got.keys() == want.keys()
    for chip in got:
        assert [dataclasses.astuple(s) for s in got[chip]] == \
            [dataclasses.astuple(s) for s in want[chip]]


def test_plancache_key_separates_specs_and_traffic(clean_plancache):
    t1, t2 = _topo(P), _topo(P, (8, 8))
    g = list(range(4))
    k = P.plancache.plan_key
    assert k(t1, "all-reduce", 1e6, g) != k(t2, "all-reduce", 1e6, g)
    assert k(t1, "all-reduce", 1e6, g) != k(t1, "all-gather", 1e6, g)
    assert k(t1, "all-reduce", 1e6, g) != k(t1, "all-reduce", 2e6, g)
    assert k(t1, "all-reduce", 1e6, g) == k(t1, "all-reduce", 1e6, list(g))


def test_plancache_disk_tier_survives_memory_clear(clean_plancache,
                                                   tmp_path):
    P.plancache.configure(str(tmp_path))
    topo = _topo(P)
    P.plancache.cached_decompose(topo, "all-gather", 2e6, list(range(4)))
    assert any(f.endswith(".torchplan") for f in os.listdir(tmp_path))
    P.plancache.clear(memory=True)
    P.plancache.reset_stats()
    P.plancache.cached_decompose(topo, "all-gather", 2e6, list(range(4)))
    s = P.plancache.stats()
    assert s["disk_hits"] == 1 and s["misses"] == 0


def test_plancache_disk_files_never_match_the_reference(clean_plancache,
                                                        tmp_path):
    """The stated departure: the plan key is the reference's (a content
    hash), but the port's files end in ``.torchplan``, so in one shared
    directory neither package's lookup hits the other's plan, and each
    package's ``clear`` deletes only its own files."""
    topo_p, topo_j = _topo(P), _topo(J)
    g = list(range(4))
    assert P.plancache.plan_key(topo_p, "all-reduce", 1e6, g) == \
        J.plancache.plan_key(topo_j, "all-reduce", 1e6, g)
    for ns in (J, P):
        ns.plancache.configure(str(tmp_path))
    J.plancache.cached_decompose(topo_j, "all-reduce", 1e6, g)
    P.plancache.cached_decompose(topo_p, "all-reduce", 1e6, g)
    assert P.plancache.stats()["disk_hits"] == 0      # not the ref's file
    assert P.plancache.stats()["misses"] == 1
    assert sorted(os.path.splitext(f)[1] for f in os.listdir(tmp_path)) \
        == [".plan", ".torchplan"]
    for ns in (P, J):                                  # fresh processes
        ns.plancache.clear(memory=True)
        ns.plancache.reset_stats()
    J.plancache.cached_decompose(topo_j, "all-reduce", 1e6, g)
    P.plancache.cached_decompose(topo_p, "all-reduce", 1e6, g)
    assert J.plancache.stats()["disk_hits"] == 1
    assert P.plancache.stats()["disk_hits"] == 1
    P.plancache.clear(memory=False, disk=True)
    assert [os.path.splitext(f)[1] for f in os.listdir(tmp_path)] == [".plan"]


def test_plancache_disk_hit_imports_nothing_of_the_reference(tmp_path):
    """A port process that reads plans from a directory the reference
    also wrote to loads only its own, and imports no ``repro``."""
    code = f"""
import sys
from repro_torch.core import SystemSpec
from repro_torch.core.topology import Topology
from repro_torch.fabric import plancache
plancache.configure({str(tmp_path)!r})
plancache.cached_decompose(Topology(SystemSpec(pod_shape=(4, 4))),
                           "all-reduce", 1e6, [0, 1, 2, 3])
assert plancache.stats()["disk_hits"] == 1, plancache.stats()
bad = [m for m in sys.modules if m.split(".")[0] in ("repro", "jax")]
assert not bad, bad
"""
    J.plancache.configure(str(tmp_path))
    P.plancache.configure(str(tmp_path))
    try:
        for ns in (J, P):
            ns.plancache.cached_decompose(_topo(ns), "all-reduce", 1e6,
                                          [0, 1, 2, 3])
    finally:
        for ns in (J, P):
            ns.plancache.configure(None)
            ns.plancache.clear()
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
