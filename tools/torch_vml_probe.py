#!/usr/bin/env python3
"""How often the first vector-math call of a fresh torch CPU process is
wrong, and which MKL kernel the wrong values come from.

torch's CPU build takes exp (log, erf, tanh, ...) of contiguous f32 and
f64 tensors from MKL's VML.  Each of ``--runs`` fresh processes (``--jobs``
at a time) takes ``torch.exp`` of 16384 f32 values in [-20, 0) as its
first VML call, then again, and reports whether the two differ:

    python tools/torch_vml_probe.py [--runs 120] [--jobs 6]
        [--env NAME=VALUE ...] [--warm] [--match]

``--env`` sets variables in the children (``OMP_NUM_THREADS=1``,
``ATEN_CPU_CAPABILITY=avx2``); ``--warm`` makes one single-threaded call
(16 elements, below torch's grain) first, as ``tests/_torch_mkl.py``
does; ``--match`` compares each wrong first result with MKL's
``vmsExp`` in its enhanced-performance mode (``VML_EP``) under
``MKL_ENABLE_INSTRUCTIONS=AVX2``, called through the copy of MKL that
torch links.  ``--pytest TEST`` runs ``python -m pytest -q TEST`` in the
fresh processes instead and counts its failures.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import concurrent.futures as futures
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import sys, numpy as np, torch
if sys.argv[2] == "1":
    torch.exp(torch.zeros(16))
m = torch.from_numpy((-20 * np.random.default_rng(0).random(16384))
                     .astype(np.float32))
e1, e2 = torch.exp(m), torch.exp(m)
bad = not torch.equal(e1, e2)
if bad:
    np.save(sys.argv[1], np.stack([m.numpy(), e1.numpy(), e2.numpy()]))
print("BAD" if bad else "OK")
"""

# vmsExp(n, a, r, mode) of the MKL inside libtorch_cpu; VML_EP = 3,
# VML_FTZDAZ_OFF = 0x140000, VML_ERRMODE_IGNORE = 0x100
MATCH = r"""
import ctypes, os, sys, numpy as np, torch
lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                               "libtorch_cpu.so"))
f = lib.vmsExp
f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong]
m, e1, e2 = np.load(sys.argv[1])
r = np.empty_like(m)
f(m.size, m.ctypes.data, r.ctypes.data, 3 | 0x140000 | 0x100)
wrong = e1 != e2
rel = np.abs(e1[wrong].astype(np.float64) / e2[wrong] - 1).max()
print(int(wrong.sum()), int((r[wrong] == e1[wrong]).sum()), rel)
"""


def child_env(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(extra)
    return env


def one(i, args, env, tmp):
    if args.pytest:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             args.pytest], cwd=ROOT, env=env, capture_output=True, text=True)
        return {"bad": proc.returncode != 0}
    path = os.path.join(tmp, f"wrong{i}.npy")
    out = subprocess.run(
        [sys.executable, "-c", CHILD, path, "1" if args.warm else "0"],
        env=env, capture_output=True, text=True, check=True).stdout.strip()
    row = {"bad": out == "BAD"}
    if row["bad"] and args.match:
        n, same, rel = subprocess.run(
            [sys.executable, "-c", MATCH, path],
            env=dict(env, MKL_ENABLE_INSTRUCTIONS="AVX2"),
            capture_output=True, text=True, check=True).stdout.split()
        row.update(wrong_values=int(n), equal_to_avx2_ep=int(same),
                   max_rel_err=float(rel))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=120)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--env", action="append", default=[])
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--match", action="store_true")
    ap.add_argument("--pytest", default="")
    args = ap.parse_args()
    env = child_env(dict(kv.split("=", 1) for kv in args.env))
    with tempfile.TemporaryDirectory() as tmp, \
            futures.ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(lambda i: one(i, args, env, tmp),
                             range(args.runs)))
    import torch
    print(json.dumps({
        "torch": torch.__version__,
        "cpu_capability": torch.backends.cpu.get_cpu_capability(),
        "threads": torch.get_num_threads(), "env": args.env,
        "warm": args.warm, "pytest": args.pytest, "runs": args.runs,
        "bad": sum(r["bad"] for r in rows),
        "matched": [r for r in rows if "wrong_values" in r]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
