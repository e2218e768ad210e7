"""MGMark launcher: every workload in U-mode and D-mode on a mesh of
shards (port of ``benchmarks/case_study.py`` and
``examples/pattern_study.py``).

  python -m repro_torch.launch.mgmark --device cuda --shards 4

One row per (workload, mode): correct against the oracle, D-mode
collective bytes per device, device ms (CUDA events, median of
``REPEATS``) and the kernel launches of the checked run.  ``--size``
defaults to each workload's ``default_size(shards)``, the paper's
Table 2 column; ``--device cpu`` runs on the CPU, with no device times.
The reference's simulated time needs the cost front end, not ported yet.
"""
from __future__ import annotations

import argparse
import typing

from repro_torch import resolve_device
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--workloads", default=",".join(WORKLOADS),
                    help="comma-separated subset of " + ",".join(WORKLOADS))
    ap.add_argument("--size", type=int, default=None,
                    help="one size for every workload (default: each "
                         "workload's default_size(shards))")
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
    ok = all(r.correct for r in reports)
    print(f"# all outputs match oracles: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
