"""Fleet-scale design-space exploration: sweep grids across worker processes.

The port's copy of ``tools/sweep.py``: it imports ``repro_torch`` only
(the simulator, the plan cache and the serving simulator of the port)
and is verbatim but for its import lines and its default paths.  Its
results go to ``sweep_results_torch.json`` and its plan cache to
``.sweep_cache_torch``, so it never takes the reference's rows as
result-cache hits (the config ids are equal) and never writes a file
the reference writes.  The reference's text follows.

The simulator used to answer one question per process; this driver
turns it into the throughput product the ROADMAP names: a declarative
**scenario x topology x scheduler x fabric x fault-plan** grid fanned
across *long-lived* worker processes.  Each worker simulates many
independent configs, so process startup (interpreter + imports) is
amortized across the whole sweep -- sidestepping the per-round
message-passing wall that caps the ``procs`` executor on weak hosts
(``BENCH_fabric.json`` ``replay_procs``): independent sims need no
mid-run IPC at all.

Two cache tiers make repeat sweeps cheap:

* **plan cache** (``repro_torch.fabric.plancache``): decomposed collective
  plans are content-hashed and shared through an on-disk directory, so
  every worker -- and every *rerun* -- skips ``decompose()`` for plans
  it has already seen (hit rate reported per sweep);
* **result cache**: each config's row is keyed by a content hash of
  the full config; a repeat run against the same results file skips
  configs that already have rows (``--force`` re-simulates).

Results merge-write into one queryable JSON (the BENCH merge-write
idiom generalized): ``{"meta": ..., "rows": {config_id: row}}``.

Usage::

  PYTHONPATH=src python tools/torch_sweep.py run --grid quick --workers 4
  PYTHONPATH=src python tools/torch_sweep.py run --grid my_grid.json
  PYTHONPATH=src python tools/torch_sweep.py query fabric=event \\
      scheduler=serial --select scenario,topology,time_s,wall_s
  PYTHONPATH=src python tools/torch_sweep.py grids   # axes + presets

A grid JSON names values for each axis (omitted axes take the quick
preset's defaults)::

  {"scenario": ["allreduce_ladder", "moe_alltoall"],
   "topology": ["pod4x4", "pod4x4x2"],
   "scheduler": ["serial"],
   "fabric": ["analytic", "event"],
   "faults": ["none", "straggler_chip"],
   "sim": {"device_limit": 16, "repeat_cap": 8}}
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import multiprocessing
import os
import signal
import sys
import time
import typing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "src") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.core import SystemSpec, simulate         # noqa: E402
from repro_torch.core.hlo import (CollectiveRecord, HloCost,  # noqa: E402
                                  TraceOp)
from repro_torch.core.hw import ChipSpec                  # noqa: E402
from repro_torch.fabric import plancache                  # noqa: E402
from repro_torch.serve import sim as serve_sim            # noqa: E402


# --------------------------------------------------------------------------
# grid axes: scenarios, topologies, fault plans
# --------------------------------------------------------------------------

def _coll(cost: HloCost, kind: str, name: str, nbytes: float,
          groups: typing.List[typing.List[int]]) -> None:
    rec = CollectiveRecord(kind, name, int(nbytes), int(nbytes),
                           int(nbytes), groups)
    cost.collectives.append(rec)
    cost.trace.append(TraceOp("collective", name, collective=rec))


def _compute(cost: HloCost, name: str, flops: float, hbm: float) -> None:
    cost.trace.append(TraceOp("compute", name, flops=flops, hbm_bytes=hbm))


def _rows(spec: SystemSpec) -> typing.List[typing.List[int]]:
    Y, X = spec.pod_shape
    return [[p * spec.chips_per_pod + y * X + x for x in range(X)]
            for p in range(spec.num_pods) for y in range(Y)]


def scenario_allreduce_ladder(spec: SystemSpec, layers: int = 8) -> HloCost:
    """Data-parallel ladder: compute segment + global all-reduce, the
    MGMark AES-analog shape (compute-heavy with periodic sync)."""
    cost = HloCost()
    groups = [list(range(spec.total_chips))]
    for i in range(layers):
        _compute(cost, f"seg{i}", 4e9, 1e8)
        _coll(cost, "all-reduce", f"ar{i}", 1e6, groups)
    return cost


def scenario_ring_exchange(spec: SystemSpec, layers: int = 6) -> HloCost:
    """Model-parallel rows: per-x-ring all-gather + reduce-scatter, with
    per-row groups -- exercises the ring formulas and, on the event
    fabric, every chip's own ICI links."""
    cost = HloCost()
    rows = _rows(spec)
    for i in range(layers):
        _compute(cost, f"mm{i}", 2e9, 5e7)
        _coll(cost, "all-gather", f"ag{i}", 2e6, rows)
        _coll(cost, "reduce-scatter", f"rs{i}", 2e6, rows)
    return cost


def scenario_moe_alltoall(spec: SystemSpec, layers: int = 6) -> HloCost:
    """MoE dispatch/combine: all-to-all over 2-D blocks (one per pod),
    bisection-limited -- plus a closing global all-reduce."""
    cost = HloCost()
    pods = [list(range(p * spec.chips_per_pod,
                       (p + 1) * spec.chips_per_pod))
            for p in range(spec.num_pods)]
    for i in range(layers):
        _compute(cost, f"expert{i}", 3e9, 8e7)
        _coll(cost, "all-to-all", f"dispatch{i}", 4e6, pods)
        _coll(cost, "all-to-all", f"combine{i}", 4e6, pods)
    _coll(cost, "all-reduce", "grad_sync", 1e6,
          [list(range(spec.total_chips))])
    return cost


def scenario_cross_pod_sync(spec: SystemSpec,
                            layers: int = 6) -> typing.Optional[HloCost]:
    """Pod-axis data parallelism: per-chip cross-pod all-reduce pairs
    sharing the DCN uplinks (the paper's D-MGPU traffic shape).  Only
    meaningful with >= 2 pods -- returns None (skip) otherwise."""
    if spec.num_pods < 2:
        return None
    cost = HloCost()
    cpp = spec.chips_per_pod
    pairs = [[k + p * cpp for p in range(spec.num_pods)] for k in range(cpp)]
    for i in range(layers):
        _compute(cost, f"step{i}", 5e9, 1e8)
        _coll(cost, "all-reduce", f"dcn_ar{i}", 8e6, pairs)
    return cost


def scenario_multi_tenant(spec: SystemSpec, layers: int = 5) -> HloCost:
    """Two tenants on disjoint halves of each pod, both running ring
    all-reduces plus a permute pipeline -- disjoint groups in one trace,
    so the event fabric sees concurrent tenants on neighboring links."""
    cost = HloCost()
    rows = _rows(spec)
    half = len(rows) // 2 or 1
    a, b = rows[:half], rows[half:] or rows[:half]
    for i in range(layers):
        _compute(cost, f"t{i}", 2.5e9 * (1.0 + 0.37 * (i % 2)), 6e7)
        _coll(cost, "all-reduce", f"tenantA_ar{i}", 2e6, a)
        _coll(cost, "all-reduce", f"tenantB_ar{i}", 1.5e6, b)
        _coll(cost, "collective-permute", f"pipe{i}", 5e5,
              [rows[0][:2]])
    return cost


# -- serving scenarios (open-loop traces; see docs/serving.md) -------------
# These return a ServingScenario instead of an HloCost; run_config
# dispatches them to repro_torch.serve.sim.run_serving, and their rows carry
# p50/p99/goodput next to the shared columns.  None = can't host the
# tenants on this topology (skipped at grid expansion, same contract).

def scenario_serving_poisson(spec: SystemSpec):
    """Two tenants, steady Poisson arrivals below the saturation knee."""
    return serve_sim.build_scenario(spec, name="serving_poisson",
                                    arrival="poisson", rate_rps=600.0,
                                    duration_s=0.02, seed=11)


def scenario_serving_overload(spec: SystemSpec):
    """Same shape offered well past the knee: queue-dominated latency."""
    return serve_sim.build_scenario(spec, name="serving_overload",
                                    arrival="poisson", rate_rps=4000.0,
                                    duration_s=0.02, seed=11)


def scenario_serving_burst(spec: SystemSpec):
    """MMPP bursts: calm/burst states stress admission + slot reuse."""
    return serve_sim.build_scenario(spec, name="serving_burst",
                                    arrival="bursty", rate_rps=600.0,
                                    duration_s=0.02, seed=11)


def scenario_serving_diurnal(spec: SystemSpec):
    """Sinusoidal rate swing (day/night) over the trace window."""
    return serve_sim.build_scenario(spec, name="serving_diurnal",
                                    arrival="diurnal", rate_rps=600.0,
                                    duration_s=0.02, seed=11)


def scenario_serving_moe(spec: SystemSpec):
    """MoE tenants: per-iteration a2a dispatch/combine rides the shared
    bisection channel, the multi-tenant contention the event fabric
    prices and analytic can't."""
    return serve_sim.build_scenario(spec, name="serving_moe",
                                    arrival="poisson", rate_rps=600.0,
                                    duration_s=0.02, seed=11, moe=True)


def scenario_serving_spare(spec: SystemSpec):
    """The poisson pair plus one reserved spare chip: a chip-kill plan
    exercises spare claim + KV migration (docs/faults.md "Spare pool,
    migration & quorum").  None when no chip is left over."""
    return serve_sim.build_scenario(spec, name="serving_spare",
                                    arrival="poisson", rate_rps=600.0,
                                    duration_s=0.02, seed=11, spares=1)


def scenario_serving_spare2(spec: SystemSpec):
    """Two shared spares: survives a double kill at full capacity."""
    return serve_sim.build_scenario(spec, name="serving_spare2",
                                    arrival="poisson", rate_rps=600.0,
                                    duration_s=0.02, seed=11, spares=2)


SCENARIOS = {
    "allreduce_ladder": scenario_allreduce_ladder,
    "ring_exchange": scenario_ring_exchange,
    "moe_alltoall": scenario_moe_alltoall,
    "cross_pod_sync": scenario_cross_pod_sync,
    "multi_tenant": scenario_multi_tenant,
    "serving_poisson": scenario_serving_poisson,
    "serving_overload": scenario_serving_overload,
    "serving_burst": scenario_serving_burst,
    "serving_diurnal": scenario_serving_diurnal,
    "serving_moe": scenario_serving_moe,
    "serving_spare": scenario_serving_spare,
    "serving_spare2": scenario_serving_spare2,
}


def _chip(**kw) -> ChipSpec:
    return dataclasses.replace(ChipSpec(), **kw)


TOPOLOGIES = {
    "pod2x2": lambda: SystemSpec(pod_shape=(2, 2)),
    "pod2x2x2": lambda: SystemSpec(pod_shape=(2, 2), num_pods=2),
    "pod4x4": lambda: SystemSpec(pod_shape=(4, 4)),
    "pod4x4x2": lambda: SystemSpec(pod_shape=(4, 4), num_pods=2),
    "pod8x8": lambda: SystemSpec(pod_shape=(8, 8)),
    "pod8x8x2": lambda: SystemSpec(pod_shape=(8, 8), num_pods=2),
    "pod4x4_slow_ici": lambda: SystemSpec(
        pod_shape=(4, 4), chip=_chip(ici_link_bandwidth=25e9)),
    "pod4x4x2_fat_dcn": lambda: SystemSpec(
        pod_shape=(4, 4), num_pods=2, dcn_bandwidth_per_pod=3.2e12),
}

SCHEDULERS = ("serial", "batch", "lookahead", "bounded")

# the port's own result file and plan-cache directory (see the docstring)
DEFAULT_OUT = "sweep_results_torch.json"
DEFAULT_CACHE_DIR = ".sweep_cache_torch"
FABRICS = ("analytic", "event")


def _faults_none(spec, fabric):
    return {}


def _faults_straggler_chip(spec, fabric):
    return {"chip0.core": [(0.0, "slow", 2.0)]}


def _faults_slow_link(spec, fabric):
    if fabric != "event":
        return None                      # link targets need the event fabric
    return {"fabric.pod0.ici[0,0]+x": [(0.0, "slow", 4.0)]}


def _faults_transient_link(spec, fabric):
    if fabric != "event":
        return None
    return {"fabric.pod0.ici[0,0]+x": [(1e-4, "transient", 2e-4)]}


def _faults_chip_kill(spec, fabric):
    """Permanent chip death mid-trace.  Pair with ``sim.deadline_s`` (and
    ``sim.recovery`` for serving scenarios, as the ``serving_recovery``
    grid does) so the death surfaces as collective timeouts instead of a
    stall bounded only by the per-config timeout."""
    return {"chip1.prog": [(5e-3, "fail", None)]}


def _faults_chip_kill_rejoin(spec, fabric):
    """Chip death + rolling-restart rejoin inside the serving window:
    the recovered chip re-registers and its tenant re-meshes back up."""
    return {"chip1.prog": [(5e-3, "fail", None), (1.2e-2, "recover", None)]}


def _faults_double_kill(spec, fabric):
    """A second chip dies while the first failure is still recovering:
    the stateful-failover stress case (spares drain one by one)."""
    return {"chip1.prog": [(5e-3, "fail", None)],
            "chip2.prog": [(8e-3, "fail", None)]}


def _faults_spare_kill(spec, fabric):
    """Kill chip1, then kill the spare (chip4) its tenant claimed.  Only
    meaningful where chip4 exists and is the first pool spare."""
    if spec.total_chips <= 4:
        return None
    return {"chip1.prog": [(5e-3, "fail", None)],
            "chip4.prog": [(9e-3, "fail", None)]}


FAULT_PLANS = {
    "none": _faults_none,
    "straggler_chip": _faults_straggler_chip,
    "slow_link": _faults_slow_link,
    "transient_link": _faults_transient_link,
    "chip_kill": _faults_chip_kill,
    "chip_kill_rejoin": _faults_chip_kill_rejoin,
    "double_kill": _faults_double_kill,
    "spare_kill": _faults_spare_kill,
}


# Named recovery-policy presets (the "policy" grid axis).  "default"
# adds no config key, so pre-existing grids keep their config hashes.
POLICY_PRESETS = {
    "default": {},
    "quorum1": {"quorum": 1},
    "quorum2": {"quorum": 2},
    "quorum3": {"quorum": 3},
    "no_backoff_cap": {"backoff_max_s": None},
}


GRIDS = {
    # CI smoke: small but crosses every axis (including an invalid
    # combo -- slow_link x analytic -- that must be *skipped*, not die)
    "quick": {
        "scenario": ["allreduce_ladder", "ring_exchange"],
        "topology": ["pod2x2", "pod4x4"],
        "scheduler": ["serial"],
        "fabric": ["analytic", "event"],
        "faults": ["none", "slow_link"],
        "sim": {"device_limit": None, "repeat_cap": 4},
    },
    # offered load x topology x scheduler x fabric x fault for the
    # open-loop serving scenarios (docs/serving.md)
    "serving": {
        "scenario": ["serving_poisson", "serving_overload", "serving_burst",
                     "serving_diurnal", "serving_moe"],
        "topology": ["pod2x2", "pod4x4"],
        "scheduler": ["serial", "bounded"],
        "fabric": ["analytic", "event"],
        "faults": ["none", "slow_link", "straggler_chip"],
        "sim": {"device_limit": None, "repeat_cap": 4},
    },
    # serve-through-faults: chip kill / kill+rejoin against the recovery
    # layer (docs/faults.md "Detection & recovery"); sim carries the
    # deadline + recovery policy that run_serving needs
    "serving_recovery": {
        "scenario": ["serving_poisson", "serving_moe"],
        "topology": ["pod2x2"],
        "scheduler": ["serial", "bounded"],
        "fabric": ["analytic", "event"],
        "faults": ["none", "chip_kill", "chip_kill_rejoin"],
        "sim": {"device_limit": None, "repeat_cap": 4,
                "deadline_s": 5e-4, "recovery": True},
    },
    # stateful failover: spares x quorum x kill plans on a topology with
    # room for a shared pool; rows carry migrated_bytes / spare_claims /
    # effective availability (docs/faults.md "Spare pool, migration &
    # quorum")
    "serving_spare": {
        "scenario": ["serving_poisson", "serving_spare", "serving_spare2"],
        "topology": ["pod2x2x2"],
        "scheduler": ["serial", "bounded"],
        "fabric": ["analytic", "event"],
        "faults": ["chip_kill", "chip_kill_rejoin", "double_kill",
                   "spare_kill"],
        "policy": ["default", "quorum2"],
        "sim": {"device_limit": None, "repeat_cap": 4,
                "deadline_s": 5e-4, "recovery": True},
    },
    # the fleet sweep: thousands of scenario points per CI run is the
    # point, but the checked-in preset stays tractable on one host
    "full": {
        "scenario": sorted(SCENARIOS),
        "topology": ["pod2x2", "pod4x4", "pod4x4x2", "pod4x4_slow_ici",
                     "pod4x4x2_fat_dcn"],
        "scheduler": ["serial", "lookahead"],
        "fabric": ["analytic", "event"],
        "faults": ["none", "straggler_chip", "slow_link"],
        "sim": {"device_limit": None, "repeat_cap": 4},
    },
}


# --------------------------------------------------------------------------
# grid expansion + config hashing
# --------------------------------------------------------------------------

def expand_grid(grid: dict) -> typing.List[dict]:
    """Cross the axes into config dicts, each with a content-hashed id.

    Unknown axis values fail here -- before any worker spins up -- and
    invalid combinations (a fault plan that needs the event fabric
    paired with analytic; a cross-pod scenario on a single-pod
    topology) are *not* expanded: they are structurally impossible
    runs, counted by the caller via the returned list's length vs the
    raw product.
    """
    spec = {**GRIDS["quick"], **grid}
    sim = {**GRIDS["quick"]["sim"], **(grid.get("sim") or {})}
    policies = list(spec.get("policy") or ["default"])
    for axis, known in (("scenario", SCENARIOS), ("topology", TOPOLOGIES),
                        ("scheduler", SCHEDULERS), ("fabric", FABRICS),
                        ("faults", FAULT_PLANS)):
        unknown = set(spec[axis]) - set(known)
        if unknown:
            raise ValueError(f"unknown {axis} values {sorted(unknown)}; "
                             f"known: {sorted(known)}")
    unknown = set(policies) - set(POLICY_PRESETS)
    if unknown:
        raise ValueError(f"unknown policy values {sorted(unknown)}; "
                         f"known: {sorted(POLICY_PRESETS)}")
    configs = []
    for scen in spec["scenario"]:
        for topo in spec["topology"]:
            sys_spec = TOPOLOGIES[topo]()
            if SCENARIOS[scen](sys_spec) is None:
                continue                      # scenario can't run here
            for sched in spec["scheduler"]:
                for fabric in spec["fabric"]:
                    for fault in spec["faults"]:
                        if FAULT_PLANS[fault](sys_spec, fabric) is None:
                            continue          # plan needs another fabric
                        for pol in policies:
                            cfg = {"scenario": scen, "topology": topo,
                                   "scheduler": sched, "fabric": fabric,
                                   "faults": fault, "sim": dict(sim)}
                            if pol != "default":
                                # "default" adds no key, so grids that
                                # predate the axis keep their hashes
                                cfg["policy"] = pol
                            cfg["config_id"] = config_id(cfg)
                            configs.append(cfg)
    return configs


def config_id(cfg: dict) -> str:
    """Content hash of one config -- the result-cache key."""
    blob = json.dumps({k: v for k, v in cfg.items() if k != "config_id"},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def grid_size(grid: dict) -> int:
    spec = {**GRIDS["quick"], **grid}
    n = 1
    for axis in ("scenario", "topology", "scheduler", "fabric", "faults"):
        n *= len(spec[axis])
    return n * len(spec.get("policy") or ["default"])


# --------------------------------------------------------------------------
# per-config execution (runs inside workers)
# --------------------------------------------------------------------------

_scenario_memo: dict = {}      # (scenario, topology) -> HloCost, per process


def run_config(cfg: dict) -> dict:
    """Simulate one config; returns its result row.  Pure function of
    the config (plus the read-only plan cache), so workers need no
    coordination."""
    spec = TOPOLOGIES[cfg["topology"]]()
    memo_key = (cfg["scenario"], cfg["topology"])
    cost = _scenario_memo.get(memo_key)
    if cost is None:
        cost = _scenario_memo[memo_key] = SCENARIOS[cfg["scenario"]](spec)
    faults = FAULT_PLANS[cfg["faults"]](spec, cfg["fabric"])
    before = plancache.stats()
    t0 = time.perf_counter()
    if isinstance(cost, serve_sim.ServingScenario):
        pol_name = cfg.get("policy", "default")
        recovery = cfg["sim"].get("recovery")
        if recovery and pol_name != "default":
            recovery = serve_sim.RecoveryPolicy(**POLICY_PRESETS[pol_name])
        rep = serve_sim.run_serving(cost, spec=spec,
                                    scheduler=cfg["scheduler"],
                                    fabric=cfg["fabric"],
                                    faults=faults or None,
                                    deadline_s=cfg["sim"].get("deadline_s"),
                                    recovery=recovery)
        wall = time.perf_counter() - t0
        after = plancache.stats()
        return {
            **{k: cfg[k] for k in ("config_id", "scenario", "topology",
                                   "scheduler", "fabric", "faults")},
            "policy": pol_name,
            "time_s": rep.time_s,
            "wall_s": round(wall, 4),
            "events": rep.events,
            "devices": rep.devices,
            "collectives_completed": rep.collectives_completed,
            "collective_timeouts": rep.collective_timeouts,
            "compute_util": round(rep.compute_util, 4),
            "offered": rep.offered,
            "completed": rep.completed,
            "offered_rps": round(rep.offered_rps, 2),
            "goodput_rps": round(rep.goodput_rps, 2),
            "p50_s": rep.p50_s,
            "p99_s": rep.p99_s,
            "queue_mean_s": rep.queue_mean_s,
            "retries": rep.retries,
            "dropped": rep.dropped,
            "recoveries": rep.recoveries,
            "rejoins": rep.rejoins,
            "chip_deaths": rep.chip_deaths,
            "tenant_availability": rep.tenant_availability,
            "tenant_effective_availability":
                rep.tenant_effective_availability,
            "spare_claims": rep.spare_claims,
            "spare_returns": rep.spare_returns,
            "migrated_bytes": rep.migrated_bytes,
            "prefill_saved_tokens": rep.prefill_saved_tokens,
            "prefill_recompute_tokens": rep.prefill_recompute_tokens,
            "plan_lookups": after["lookups"] - before["lookups"],
            "plan_misses": after["misses"] - before["misses"],
        }
    rep = simulate(cost=cost, spec=spec, scheduler=cfg["scheduler"],
                   fabric=cfg["fabric"], faults=faults or None,
                   device_limit=cfg["sim"].get("device_limit"),
                   repeat_cap=cfg["sim"].get("repeat_cap", 64),
                   deadline_s=cfg["sim"].get("deadline_s"))
    wall = time.perf_counter() - t0
    after = plancache.stats()
    return {
        **{k: cfg[k] for k in ("config_id", "scenario", "topology",
                               "scheduler", "fabric", "faults")},
        "time_s": rep.time_s,
        "wall_s": round(wall, 4),
        "events": rep.events,
        "devices": rep.devices,
        "collectives_completed": rep.collectives_completed,
        "collective_timeouts": rep.collective_timeouts,
        "compute_util": round(rep.compute_util, 4),
        "plan_lookups": after["lookups"] - before["lookups"],
        "plan_misses": after["misses"] - before["misses"],
    }


_CFG_TIMEOUT: typing.Optional[float] = None   # per-config wall budget (s)


class _ConfigTimeout(Exception):
    """One config exceeded its wall-clock budget (raised from SIGALRM)."""


def _on_alarm(signum, frame):
    raise _ConfigTimeout()


def _configure_timeout(timeout_s: typing.Optional[float]) -> None:
    global _CFG_TIMEOUT
    _CFG_TIMEOUT = timeout_s
    if timeout_s and hasattr(signal, "SIGALRM"):
        signal.signal(signal.SIGALRM, _on_alarm)


def _worker_init(cache_dir: typing.Optional[str],
                 config_timeout_s: typing.Optional[float] = None) -> None:
    plancache.configure(cache_dir)
    plancache.reset_stats()
    _configure_timeout(config_timeout_s)


def _run_one(cfg: dict) -> dict:
    """Run one config under a wall-clock budget, with one retry.

    ``_run_one`` has always caught exceptions (one bad config != dead
    sweep), but a *wedged* simulation -- a fault plan that stalls the
    event loop with no deadline to cut it -- used to hang its worker and
    with it the whole pool.  With a configured ``config_timeout_s`` each
    attempt runs under a SIGALRM itimer: the first timeout gets one
    retry (transient host stalls deserve a second chance and the memo /
    plan caches are warm now), the second yields an error row so the
    sweep always completes.  Every row records ``attempts``.
    """
    base = {k: cfg[k] for k in ("config_id", "scenario", "topology",
                                "scheduler", "fabric", "faults")}
    timed_out = None
    for attempt in (1, 2):
        armed = bool(_CFG_TIMEOUT) and hasattr(signal, "SIGALRM")
        try:
            if armed:
                signal.setitimer(signal.ITIMER_REAL, _CFG_TIMEOUT)
            row = run_config(cfg)
            row["attempts"] = attempt
            return row
        except _ConfigTimeout:
            timed_out = (f"_ConfigTimeout: exceeded "
                         f"{_CFG_TIMEOUT}s (attempt {attempt})")
        except Exception as e:                # one bad config != dead sweep
            return {**base, "attempts": attempt,
                    "error": f"{type(e).__name__}: {e}"}
        finally:
            if armed:
                signal.setitimer(signal.ITIMER_REAL, 0.0)
    return {**base, "attempts": 2, "error": timed_out}


# --------------------------------------------------------------------------
# results file: merge-write + query
# --------------------------------------------------------------------------

def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"meta": {}, "rows": {}}


def merge_results(path: str, rows: typing.List[dict], meta: dict) -> dict:
    """Read-merge-write (the BENCH_*.json idiom): concurrent sweeps over
    different grids may share one results file; neither clobbers the
    other's rows."""
    data = load_results(path)
    for row in rows:
        data["rows"][row["config_id"]] = row
    data["meta"].update(meta)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return data


def query_rows(data: dict, where: dict = None,
               select: typing.List[str] = None) -> typing.List[dict]:
    """Filter result rows by exact field match; optionally project.
    Values compare as strings so CLI ``key=value`` tokens work for
    numeric fields too."""
    out = []
    for row in sorted(data.get("rows", {}).values(),
                      key=lambda r: r["config_id"]):
        if where and any(str(row.get(k)) != str(v)
                         for k, v in where.items()):
            continue
        out.append({k: row.get(k) for k in select} if select else row)
    return out


# --------------------------------------------------------------------------
# the sweep itself
# --------------------------------------------------------------------------

def run_sweep(grid: dict, out: str, workers: int = None,
              cache_dir: str = None, force: bool = False,
              quiet: bool = False,
              config_timeout_s: float = None) -> dict:
    """Expand, fan out, merge-write.  Returns the sweep stats dict
    (also merged into the results file's ``meta``).

    ``workers=0`` runs inline (no pool) -- for tests and tiny grids;
    ``workers=None`` picks ``os.cpu_count()``.  Workers are long-lived:
    one pool serves the entire grid.

    ``config_timeout_s`` bounds each config's wall time (SIGALRM, so
    inline and forked workers alike): first breach retries once, second
    writes an error row -- a wedged simulation can no longer hang the
    sweep.  ``None`` (default) keeps the old unbounded behavior.
    """
    t_start = time.perf_counter()
    _configure_timeout(config_timeout_s)
    configs = expand_grid(grid)
    raw = grid_size(grid)
    existing = load_results(out)["rows"] if not force else {}
    todo = [c for c in configs if c["config_id"] not in existing]
    cached = len(configs) - len(todo)
    if workers is None:
        workers = os.cpu_count() or 1
    plancache.reset_stats()
    if cache_dir:
        plancache.configure(cache_dir)
    rows: typing.List[dict] = []
    if todo:
        if workers <= 0 or len(todo) == 1:
            rows = [_run_one(c) for c in todo]
            pstats = plancache.stats()
        else:
            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(processes=min(workers, len(todo)),
                          initializer=_worker_init,
                          initargs=(cache_dir, config_timeout_s)) as pool:
                rows = list(pool.imap_unordered(_run_one, todo, chunksize=1))
            # workers are gone; their plan-cache traffic survives in the
            # per-row counters
            pstats = {"lookups": sum(r.get("plan_lookups", 0) for r in rows),
                      "misses": sum(r.get("plan_misses", 0) for r in rows)}
            pstats["hits"] = pstats["lookups"] - pstats["misses"]
            pstats["hit_rate"] = (pstats["hits"] / pstats["lookups"]
                                  if pstats["lookups"] else 0.0)
    else:
        pstats = plancache.stats()
    errors = [r for r in rows if "error" in r]
    wall = time.perf_counter() - t_start
    stats = {
        "grid_points": len(configs),
        "grid_points_raw": raw,
        "skipped_invalid": raw - len(configs),
        "simulated": len(todo),
        "result_cache_hits": cached,
        "errors": len(errors),
        "wall_s": round(wall, 3),
        "configs_per_sec": round(len(configs) / wall, 2),
        "workers": workers,
        "plan_cache_lookups": pstats["lookups"],
        "plan_cache_hit_rate": round(pstats["hit_rate"], 4),
        "written_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    merge_results(out, rows, stats)
    if not quiet:
        print(f"# sweep: {stats['grid_points']} grid points "
              f"({stats['skipped_invalid']} invalid combos skipped), "
              f"{stats['simulated']} simulated / "
              f"{stats['result_cache_hits']} cached rows, "
              f"{stats['errors']} errors, {wall:.2f}s "
              f"({stats['configs_per_sec']:.1f} configs/s, "
              f"{workers} workers, plan-cache hit rate "
              f"{stats['plan_cache_hit_rate']:.2f})")
        for r in errors[:5]:
            print(f"#   ERROR {r['config_id']}: {r['error']}")
        print(f"# results -> {out}")
    return stats


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def _load_grid(name_or_path: str) -> dict:
    if name_or_path in GRIDS:
        return GRIDS[name_or_path]
    with open(name_or_path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="expand a grid and sweep it")
    run_p.add_argument("--grid", default="quick",
                       help="preset name (%s) or a grid JSON path"
                            % "/".join(sorted(GRIDS)))
    run_p.add_argument("--out", default=DEFAULT_OUT)
    run_p.add_argument("--workers", type=int, default=None,
                       help="worker processes (0 = inline; "
                            "default: cpu count)")
    run_p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                       help="plan-cache directory shared by workers "
                            "('' disables the disk tier)")
    run_p.add_argument("--force", action="store_true",
                       help="re-simulate configs already in the results")
    run_p.add_argument("--timeout", type=float, default=None,
                       help="per-config wall budget in seconds (one "
                            "retry, then an error row; default: none)")

    q_p = sub.add_parser("query", help="filter merged sweep results")
    q_p.add_argument("filters", nargs="*",
                     help="key=value exact-match filters")
    q_p.add_argument("--results", default=DEFAULT_OUT)
    q_p.add_argument("--select", default=None,
                     help="comma-separated fields to project")

    sub.add_parser("grids", help="list axes and grid presets")

    args = ap.parse_args(argv)
    if hasattr(signal, "SIGPIPE"):      # `sweep.py query | head` etc.
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    if args.cmd == "grids":
        print(json.dumps({"scenarios": sorted(SCENARIOS),
                          "topologies": sorted(TOPOLOGIES),
                          "schedulers": list(SCHEDULERS),
                          "fabrics": list(FABRICS),
                          "fault_plans": sorted(FAULT_PLANS),
                          "policies": sorted(POLICY_PRESETS),
                          "grids": GRIDS}, indent=2))
        return 0
    if args.cmd == "query":
        where = dict(tok.split("=", 1) for tok in args.filters)
        select = args.select.split(",") if args.select else None
        rows = query_rows(load_results(args.results), where, select)
        print(json.dumps(rows, indent=2, sort_keys=True))
        return 0
    stats = run_sweep(_load_grid(args.grid), out=args.out,
                      workers=args.workers,
                      cache_dir=args.cache_dir or None, force=args.force,
                      config_timeout_s=args.timeout)
    return 1 if stats["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
