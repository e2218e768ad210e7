"""tools/torch_sweep.py against tools/sweep.py (CPU): the cases of
tests/test_sweep.py on the port's copy.

The port's rows are held with ``==`` to the reference's for the same
configs, leaving out the fields a run's wall clock or its process's
plan-cache state sets.  The worker-pool run goes through the command
line in a fresh interpreter (the pool forks), from a scratch directory,
which also shows where the port's defaults write: its own results file
and plan-cache directory, never the reference's."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from _torch_sim_nodes import REPO, child_env  # noqa: E402
from tools import sweep as ref_sweep  # noqa: E402
from tools import torch_sweep as sweep  # noqa: E402

TINY = {
    "scenario": ["allreduce_ladder"],
    "topology": ["pod2x2"],
    "scheduler": ["serial"],
    "fabric": ["analytic", "event"],
    "faults": ["none"],
}
# set by a run's wall clock, or by what its process's plan cache held
RUN_FIELDS = ("wall_s", "plan_lookups", "plan_misses")


def _sim_fields(row):
    return {k: v for k, v in row.items() if k not in RUN_FIELDS}


@pytest.fixture(autouse=True)
def clean_caches():
    for mod in (sweep, ref_sweep):
        mod.plancache.clear()
        mod.plancache.reset_stats()
        mod.plancache.configure(None)
        mod._scenario_memo.clear()
    yield
    for mod in (sweep, ref_sweep):
        mod.plancache.configure(None)
        mod._configure_timeout(None)


# -- grid expansion ----------------------------------------------------------

def test_axes_and_grids_equal_the_reference():
    for name in ("SCENARIOS", "TOPOLOGIES", "FAULT_PLANS", "POLICY_PRESETS"):
        assert sorted(getattr(sweep, name)) == \
            sorted(getattr(ref_sweep, name))
    assert sweep.SCHEDULERS == ref_sweep.SCHEDULERS
    assert sweep.FABRICS == ref_sweep.FABRICS
    assert sweep.GRIDS == ref_sweep.GRIDS


@pytest.mark.parametrize("grid", ["quick", "serving", "serving_spare"])
def test_expand_grid_equals_reference(grid):
    configs = sweep.expand_grid(sweep.GRIDS[grid])
    assert configs == ref_sweep.expand_grid(ref_sweep.GRIDS[grid])
    assert len({c["config_id"] for c in configs}) == len(configs)
    assert configs == sweep.expand_grid(sweep.GRIDS[grid])


def test_expand_grid_skips_structurally_invalid_combos():
    grid = {**TINY, "scenario": ["cross_pod_sync"],
            "faults": ["none", "slow_link"]}
    assert sweep.expand_grid(grid) == []
    grid["topology"] = ["pod4x4x2"]
    combos = {(c["fabric"], c["faults"]) for c in sweep.expand_grid(grid)}
    assert combos == {("analytic", "none"), ("event", "none"),
                      ("event", "slow_link")}


def test_expand_grid_rejects_unknown_axis_values():
    with pytest.raises(ValueError, match="unknown scenario"):
        sweep.expand_grid({**TINY, "scenario": ["warp_drive"]})
    with pytest.raises(ValueError, match="unknown topology"):
        sweep.expand_grid({**TINY, "topology": ["pod0x0"]})
    with pytest.raises(ValueError, match="unknown policy"):
        sweep.expand_grid({**TINY, "policy": ["warp_quorum"]})


# -- rows against tools/sweep.py ---------------------------------------------

def test_quick_grid_rows_equal_the_reference():
    """Every config of the quick grid, simulated inline by both tools:
    equal rows but for wall-clock and plan-cache counters."""
    configs = sweep.expand_grid(sweep.GRIDS["quick"])
    assert configs
    for cfg in configs:
        got = sweep._run_one(cfg)
        assert "error" not in got, got
        assert _sim_fields(got) == _sim_fields(ref_sweep._run_one(cfg))


@pytest.mark.parametrize("grid,override", [
    ("serving_recovery", {"scenario": ["serving_poisson"],
                          "faults": ["chip_kill"]}),
    ("serving_spare", {"scenario": ["serving_spare"],
                       "faults": ["chip_kill"], "policy": ["default"]}),
    ("serving", {"scenario": ["serving_moe"], "topology": ["pod2x2"],
                 "faults": ["slow_link"]}),
], ids=["recovery", "spare", "serving_moe_slow_link"])
def test_serving_rows_equal_the_reference(grid, override):
    spec = {**sweep.GRIDS[grid], "scheduler": ["serial"], **override}
    for cfg in sweep.expand_grid(spec):
        got = sweep.run_config(cfg)
        assert "error" not in got
        assert _sim_fields(got) == _sim_fields(ref_sweep.run_config(cfg))


def test_serving_recovery_grid_runs_with_recovery_columns():
    grid = {**sweep.GRIDS["serving_recovery"],
            "scenario": ["serving_poisson"], "scheduler": ["serial"],
            "fabric": ["analytic"], "faults": ["chip_kill"]}
    cfg = sweep.expand_grid(grid)[0]
    assert cfg["sim"]["deadline_s"] and cfg["sim"]["recovery"]
    row = sweep.run_config(cfg)
    assert row["collective_timeouts"] >= 1
    assert row["retries"] >= 1 and row["recoveries"] >= 1
    assert row["chip_deaths"] == 1
    assert row["tenant_availability"][0] < 1.0
    assert row["tenant_availability"][1] == 1.0
    assert row["completed"] + row["dropped"] == row["offered"]


def test_serving_spare_grid_runs_with_failover_columns():
    grid = {**sweep.GRIDS["serving_spare"],
            "scenario": ["serving_spare"], "scheduler": ["serial"],
            "fabric": ["analytic"], "faults": ["chip_kill"],
            "policy": ["default", "quorum2"]}
    cfgs = sweep.expand_grid(grid)
    assert {c.get("policy") for c in cfgs} == {None, "quorum2"}
    row = sweep.run_config(cfgs[0])
    assert row["policy"] == "default"
    assert row["chip_deaths"] == 1 and row["spare_claims"] == 1
    assert row["migrated_bytes"] > 0 and row["prefill_saved_tokens"] > 0
    assert row["completed"] + row["dropped"] == row["offered"]
    assert 0.0 < row["tenant_effective_availability"][0] <= 1.0


def test_spare_kill_plan_needs_a_spare_chip():
    assert sweep._faults_spare_kill(sweep.TOPOLOGIES["pod2x2"](),
                                    "analytic") is None
    assert sweep._faults_spare_kill(sweep.TOPOLOGIES["pod2x2x2"](),
                                    "analytic") is not None


def test_run_config_rows_have_stable_schema():
    row = sweep.run_config(sweep.expand_grid(TINY)[0])
    for field in ("config_id", "scenario", "topology", "scheduler",
                  "fabric", "faults", "time_s", "wall_s", "events",
                  "plan_lookups", "plan_misses"):
        assert field in row


# -- the results file --------------------------------------------------------

def test_sweep_inline_writes_queryable_results(tmp_path):
    out = str(tmp_path / "results.json")
    stats = sweep.run_sweep(TINY, out=out, workers=0, quiet=True)
    assert stats["grid_points"] == stats["simulated"] == 2
    assert stats["errors"] == 0
    data = json.loads(open(out).read())
    assert set(data) == {"meta", "rows"} and len(data["rows"]) == 2
    rows = sweep.query_rows(data, {"fabric": "event"}, ["time_s", "events"])
    assert len(rows) == 1 and rows[0]["time_s"] > 0
    assert {r["devices"] for r in sweep.query_rows(data)} == {4}


def test_sweep_repeat_run_hits_result_cache(tmp_path):
    out = str(tmp_path / "results.json")
    first = sweep.run_sweep(TINY, out=out, workers=0, quiet=True)
    again = sweep.run_sweep(TINY, out=out, workers=0, quiet=True)
    assert again["simulated"] == 0
    assert again["result_cache_hits"] == first["grid_points"]
    forced = sweep.run_sweep(TINY, out=out, workers=0, force=True,
                             quiet=True)
    assert forced["simulated"] == first["grid_points"]


def test_sweep_merge_preserves_other_grids_rows(tmp_path):
    out = str(tmp_path / "results.json")
    sweep.run_sweep(TINY, out=out, workers=0, quiet=True)
    other = {**TINY, "fabric": ["analytic"], "faults": ["straggler_chip"]}
    sweep.run_sweep(other, out=out, workers=0, quiet=True)
    data = sweep.load_results(out)
    assert len(data["rows"]) == 3
    slow = sweep.query_rows(data, {"faults": "straggler_chip"})
    none = sweep.query_rows(data, {"faults": "none", "fabric": "analytic"})
    assert slow[0]["time_s"] > none[0]["time_s"]


# -- timeouts and retries ----------------------------------------------------

def test_run_one_times_out_and_retries_once(monkeypatch):
    import time as _time
    cfg = dict(sweep.expand_grid(TINY)[0])
    calls = {"n": 0}

    def hang(c):
        calls["n"] += 1
        while True:
            _time.sleep(0.01)

    monkeypatch.setattr(sweep, "run_config", hang)
    sweep._configure_timeout(0.2)
    row = sweep._run_one(cfg)
    assert calls["n"] == 2
    assert row["attempts"] == 2
    assert "_ConfigTimeout" in row["error"]
    assert row["config_id"] == cfg["config_id"]


def test_run_one_hang_then_success_records_attempts(monkeypatch):
    import time as _time
    cfg = dict(sweep.expand_grid(TINY)[0])
    calls = {"n": 0}

    def flaky(c):
        calls["n"] += 1
        if calls["n"] == 1:
            while True:
                _time.sleep(0.01)
        return {"config_id": c["config_id"], "ok": True}

    monkeypatch.setattr(sweep, "run_config", flaky)
    sweep._configure_timeout(0.2)
    row = sweep._run_one(cfg)
    assert row == {"config_id": cfg["config_id"], "ok": True, "attempts": 2}


def test_run_one_exception_still_no_retry(monkeypatch):
    cfg = dict(sweep.expand_grid(TINY)[0])
    monkeypatch.setattr(sweep, "run_config",
                        lambda c: (_ for _ in ()).throw(ValueError("bad")))
    sweep._configure_timeout(5.0)
    row = sweep._run_one(cfg)
    assert row["attempts"] == 1 and "ValueError" in row["error"]


def test_sweep_rows_record_attempts(tmp_path):
    out = str(tmp_path / "results.json")
    stats = sweep.run_sweep(TINY, out=out, workers=0, quiet=True,
                            config_timeout_s=60.0)
    assert stats["errors"] == 0
    rows = sweep.load_results(out)["rows"]
    assert all(r["attempts"] == 1 for r in rows.values())


# -- the port's own paths, and a worker pool ---------------------------------

def test_defaults_do_not_collide_with_the_reference():
    assert sweep.DEFAULT_OUT == "sweep_results_torch.json"
    assert sweep.DEFAULT_CACHE_DIR == ".sweep_cache_torch"
    src = open(os.path.join(REPO, "tools", "sweep.py")).read()
    assert 'default="sweep_results.json"' in src
    assert 'default=".sweep_cache"' in src
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert {"sweep_results_torch.json", ".sweep_cache_torch/"} <= \
        set(ignored)


def _cli(cwd, *args):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_sweep.py"),
         *args], cwd=cwd, env=child_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_worker_pool_matches_inline_and_reruns_hit_the_plan_cache(tmp_path):
    """The command line with its default paths, from a scratch
    directory: two workers give the inline rows, the results and plans
    land in the port's own files, and a forced rerun takes every plan
    from the disk tier."""
    grid = {**TINY, "topology": ["pod2x2", "pod4x4"]}
    (tmp_path / "grid.json").write_text(json.dumps(grid))
    _cli(tmp_path, "run", "--grid", "grid.json", "--workers", "2")
    assert sorted(os.listdir(tmp_path)) == [
        ".sweep_cache_torch", "grid.json", "sweep_results_torch.json"]
    plans = os.listdir(tmp_path / ".sweep_cache_torch")
    assert plans and all(p.endswith(".torchplan") for p in plans)
    pool = sweep.load_results(str(tmp_path / "sweep_results_torch.json"))
    inline = str(tmp_path / "inline.json")
    sweep.run_sweep(grid, out=inline, workers=0, quiet=True)
    inline_rows = sweep.load_results(inline)["rows"]
    assert set(pool["rows"]) == set(inline_rows)
    for cid, row in pool["rows"].items():
        assert _sim_fields(row) == _sim_fields(inline_rows[cid])
    assert pool["meta"]["workers"] == 2
    _cli(tmp_path, "run", "--grid", "grid.json", "--workers", "2", "--force")
    meta = sweep.load_results(
        str(tmp_path / "sweep_results_torch.json"))["meta"]
    assert meta["plan_cache_lookups"] > 0
    assert meta["plan_cache_hit_rate"] == 1.0
    out = json.loads(_cli(tmp_path, "query", "fabric=event",
                          "--select", "fabric,time_s"))
    assert len(out) == 2 and {r["fabric"] for r in out} == {"event"}
