"""MGMark launcher: every workload in U-mode and D-mode on a mesh of
shards (port of ``benchmarks/case_study.py``, ``examples/pattern_study.py``
and ``benchmarks/mgmark_validation.py``).

  python -m repro_torch.launch.mgmark --device cuda --shards 4 [--validate]

One row per (workload, mode): correct against the oracle, collective
bytes per device (D-mode: the shard mesh's counted copies; U-mode: the
collectives DTensor issues for the global program), the SIMULATED time
and compute utilisation of the traced program on a ``SystemSpec`` of
``shards`` chips (the reference's default chip, a TPU v5e: configured,
not measured), device ms (CUDA events, median of ``REPEATS``) and the
kernel launches of the checked run.  ``--size`` defaults to each
workload's ``default_size(shards)``, the paper's Table 2 column;
``--device cpu`` runs on the CPU, with no device times.  ``--validate``
adds each workload's D-mode simulated time over the reference's
analytic bound (FLOPs over peak, plus bytes over HBM bandwidth, plus
``collective_sim_time``), and the paper's four lessons on these numbers.
"""
from __future__ import annotations

import argparse
import typing

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import SystemSpec, simulate
from repro_torch.core.roofline import collective_sim_time
from repro_torch.patterns import WORKLOADS, Mesh, PatternReport, evaluate
from repro_torch.patterns.base import MODES

REPEATS = 5                     # timed calls per run on the card


def workload_inputs(name: str, size: int):
    """(program arguments, oracle) of one workload from seed 0, as the
    reference's case study builds them (AES passes round keys and the
    S-box, not the key)."""
    mod = WORKLOADS[name]
    args = mod.make_args(size)
    if name == "aes":
        plain, key, rk, sb = args
        return (plain, rk, sb), mod.reference(plain, key)
    return args, mod.reference(*args)


def run_suite(mesh: Mesh, names: typing.Sequence[str] = tuple(WORKLOADS),
              sizes: typing.Mapping[str, int] = None
              ) -> typing.List[PatternReport]:
    """``evaluate`` every named workload in both modes on ``mesh``, at
    ``sizes[name]`` (default ``default_size(mesh.size)``), each timed
    over ``REPEATS`` calls on a CUDA mesh."""
    reports = []
    for name in names:
        mod = WORKLOADS[name]
        size = (sizes or {}).get(name, mod.default_size(mesh.size))
        args, oracle = workload_inputs(name, size)
        for mode in MODES:
            prog = getattr(mod, f"make_{mode}")(mesh)
            reports.append(evaluate(name, mod.PATTERN, mode, prog, args,
                                    oracle, mesh, repeats=REPEATS))
    return reports


def validate(reports: typing.Sequence[PatternReport],
             spec: SystemSpec) -> typing.List[dict]:
    """Each D-mode report's traced program SIMULATED on ``spec`` against
    the reference's analytic bound there (``benchmarks/
    mgmark_validation.py:38-47``: FLOPs over peak, plus HBM bytes over
    bandwidth, plus ``collective_sim_time``)."""
    out = []
    for r in reports:
        if r.mode != "dmode":
            continue
        c = spec.chip
        sim = simulate(cost=r.cost, spec=spec, device_limit=8).time_s
        bound = (r.cost.flops / c.peak_bf16_flops
                 + r.cost.hbm_bytes / c.hbm_bandwidth
                 + collective_sim_time(r.cost, spec))
        out.append({"name": r.name, "sim_s": sim, "bound_s": bound,
                    "ratio": sim / max(bound, 1e-12)})
    return out


def lessons(reports: typing.Sequence[PatternReport]) -> typing.List[str]:
    """The paper's four design lessons (``examples/pattern_study.py``),
    evaluated on ``reports`` (both modes of every workload): traffic per
    device and SIMULATED time."""
    by = {(r.name, r.mode): r for r in reports}
    names = [n for n in WORKLOADS if (n, "umode") in by and (n, "dmode") in by]
    extra = {n: by[(n, "umode")].collective_bytes
             - by[(n, "dmode")].collective_bytes for n in names}
    db = np.array([extra[n] for n in names], dtype=np.float64)
    dt = np.array([by[(n, "umode")].sim_time_s - by[(n, "dmode")].sim_time_s
                   for n in names])
    corr = (float(np.corrcoef(db, dt)[0, 1])
            if len(names) > 1 and db.std() > 0 and dt.std() > 0
            else float("nan"))
    heaviest = max(names, key=lambda n: by[(n, "umode")].collective_bytes)
    aes = by.get(("aes", "dmode"))
    return [
        f"1. partitioned => zero traffic: AES D-mode "
        f"{'n/a' if aes is None else f'{aes.collective_bytes:.0f}'} B",
        f"2. explicit placement saves traffic on: "
        f"{[n for n in names if extra[n] > 0]}",
        f"3. corr(extra traffic, extra simulated time) U vs D = {corr:.2f} "
        f"(paper: 'strongly correlated')",
        f"4. traffic-heaviest pattern under the unified model: {heaviest} "
        f"(paper: Irregular/BS)"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated subset of " + ",".join(WORKLOADS))
    ap.add_argument("--size", type=int, default=None,
                    help="one size for every workload (default: each "
                         "workload's default_size(shards))")
    ap.add_argument("--validate", action="store_true",
                    help="print each D-mode run's simulated time over the "
                         "reference's analytic bound, and the paper's "
                         "lessons")
    args = ap.parse_args(argv)

    names = [n for n in args.workloads.split(",") if n]
    unknown = sorted(set(names) - set(WORKLOADS))
    if unknown:
        ap.error(f"unknown workloads {unknown}; known: {list(WORKLOADS)}")
    dev = resolve_device(args.device)
    mesh = Mesh([dev] * args.shards)
    sizes = None if args.size is None else dict.fromkeys(names, args.size)
    reports = run_suite(mesh, names, sizes)
    for rep in reports:
        print(rep.row())
    if args.validate:
        print("# D-mode simulated / analytic bound (SIMULATED on the "
              "reference's default SystemSpec, a TPU v5e chip: configured, "
              "not measured)")
        for v in validate(reports, SystemSpec(pod_shape=(1, args.shards))):
            print(f"{v['name']:4s} sim {v['sim_s'] * 1e6:.3f} us, bound "
                  f"{v['bound_s'] * 1e6:.3f} us, ratio {v['ratio']:.3f}")
        for line in lessons(reports):
            print("# " + line)
    ok = all(r.correct for r in reports)
    print(f"# all outputs match oracles: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
