"""The paper's case study on the PyTorch port: U-MGPU against D-MGPU
across the five collaborative-execution patterns (port of
``examples/pattern_study.py``).

  PYTHONPATH=src python examples/pattern_study_torch.py [--device cpu|cuda]

Prints, per workload and mode: oracle-checked correctness, traffic per
device (D-mode: the shard mesh's collectives; U-mode: the collectives
DTensor issues for the global program), the SIMULATED time of the traced
program on the 4-chip system model (the reference's default chip, a TPU
v5e: configured, not measured) and, on the card, the device ms of a run
on 4 shards of one GPU: the Fig. 9 bars as a table, then the paper's four
design lessons on these numbers.
"""
import argparse

from repro_torch import resolve_device
from repro_torch.launch import mgmark
from repro_torch.patterns import Mesh

SIZES = {"aes": 64 * 1024, "km": 32 * 1024, "fir": 64 * 1024, "sc": 512,
         "gd": 16 * 1024, "mt": 512, "bs": 32 * 1024}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    mesh = Mesh([resolve_device(args.device)] * 4)
    rows = mgmark.run_suite(mesh, sizes=SIZES)
    print(f"{'workload':9s} {'pattern':12s} {'mode':6s} {'ok':3s} "
          f"{'traffic(B)':>12s} {'simulated':>12s} {'device':>12s}")
    for r in rows:
        ms = "-" if r.device_ms is None else f"{r.device_ms * 1e3:.1f}us"
        print(f"{r.name:9s} {r.pattern:12s} {r.mode:6s} "
              f"{'yes' if r.correct else 'NO ':3s} "
              f"{r.collective_bytes:12.0f} {r.sim_time_s * 1e6:10.3f}us "
              f"{ms:>12s}")
    print("\npaper lessons, evaluated:")
    for line in mgmark.lessons(rows):
        print(" " + line)
    return 0 if all(r.correct for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
