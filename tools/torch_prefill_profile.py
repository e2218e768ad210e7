#!/usr/bin/env python3
"""Device time of a full-width prefill and of decode steps of the
PyTorch port, by kernel.

Builds a served model at full width (random weights from seed 0), runs
one warm prefill of ``chip_smoke.py``'s 995-token probe (prompt from
``numpy.random.default_rng(0)``), then profiles ``--reps`` prefills with
torch.profiler and prints, per prefill: the device busy time (the sum of
every CUDA kernel's self time), the time and launches of the attention
or SSD kernel of the model's path, the largest other kernels, and the
CUDA-event time around the prefill (host gaps included).

Then it fills the 4 slots of a ``repro_torch.serve.Engine`` (max_seq
2048, 128-token prompts) and takes ``DECODE_STEPS`` decode-only
engine steps twice: unprofiled, for the step time (host clock around
steps ending in a synchronize), and under torch.profiler, for the
device busy ms, the kernel launches and the port's kernel-wrapper
launches per step.

``--src`` names the ``src`` directory of the tree to import
``repro_torch`` from, so the same window can be taken of two trees
(for example this checkout and its parent unpacked with ``git
archive``) in one run on one card:

    python tools/torch_prefill_profile.py [--src DIR] [--arch qwen2-1.5b]

Needs a CUDA device; prints one JSON object per model and window, the
last line holding all of them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

PROBE_LEN = 995
# the kernel of each model's path whose time the redesign moves, by a
# substring of its device symbol
PATH_KERNEL = {"qwen2-1.5b": "flash_fwd", "mamba2-1.3b": "ssd_chunk_kernel"}
# decode-only engine steps in each decode window
DECODE_STEPS = 8


def profile_prefill(arch: str, reps: int) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api, get_config
    cfg = get_config(arch)
    params = api.init(0, cfg, device="cuda")
    probe = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, PROBE_LEN), device="cuda")[None]

    def prefill():
        cache = api.init_cache(cfg, 1, PROBE_LEN)
        return api.prefill(params, cfg, cache, {"tokens": probe})

    prefill()                                   # builds and warms
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        prefill()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            prefill()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    mine = [e for e in kernels if PATH_KERNEL[arch] in e.key]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"arch": arch, "src": str(pathlib.Path(sys.path[0]).resolve()),
           "reps": reps, "event_ms_per_prefill": event_ms,
           "device_busy_ms_per_prefill": busy,
           "path_kernel": PATH_KERNEL[arch],
           "path_kernel_ms_per_prefill":
               sum(e.self_device_time_total for e in mine) / 1e3 / reps,
           "path_kernel_launches_per_prefill":
               sum(e.count for e in mine) / reps,
           "top_kernels_ms_per_prefill": {
               e.key[:60]: e.self_device_time_total / 1e3 / reps
               for e in top},
           "device": torch.cuda.get_device_name(0)}
    del params
    torch.cuda.empty_cache()
    return out


def profile_decode(arch: str) -> dict:
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.models import api, get_config
    from repro_torch.serve import Engine, Request
    steps = DECODE_STEPS
    cfg = get_config(arch)
    params = api.init(0, cfg, device="cuda")
    eng = Engine(cfg, params, slots=4, max_seq=2048, device="cuda")
    rng = np.random.default_rng(0)
    for uid in range(eng.slots):
        eng.submit(Request(uid=uid, max_new_tokens=2 * steps + 8,
                           prompt=rng.integers(0, cfg.vocab_size, 128)))
    eng.step()                                  # admits every slot
    for _ in range(3):                          # warm decode steps
        eng.step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    before = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    after = ops.launch_counts()
    full = len(eng.active) == eng.slots         # every step was decode-only
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"arch": arch, "src": str(pathlib.Path(sys.path[0]).resolve()),
           "decode_steps": steps, "all_slots_active": full,
           "step_ms": step_ms, "step_ms_median": sorted(step_ms)[steps // 2],
           "device_busy_ms_per_step":
               sum(e.self_device_time_total for e in kernels) / 1e3 / steps,
           "kernel_launches_per_step":
               sum(e.count for e in kernels) / steps,
           "wrapper_launches_per_step": {
               k: (after[k] - before[k]) / steps for k in after
               if after[k] != before[k]},
           "top_kernels_ms_per_step": {
               e.key[:60]: e.self_device_time_total / 1e3 / steps
               for e in top},
           "device": torch.cuda.get_device_name(0)}
    del params, eng
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--arch", action="append", choices=sorted(PATH_KERNEL))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("torch_prefill_profile: no CUDA device", file=sys.stderr)
        return 2
    rows, decode = [], []
    for arch in args.arch or sorted(PATH_KERNEL, reverse=True):
        rows.append(profile_prefill(arch, args.reps))
        print(json.dumps(rows[-1]), flush=True)
        decode.append(profile_decode(arch))
        print(json.dumps(decode[-1]), flush=True)
    print(json.dumps({"prefill_profiles": rows, "decode_profiles": decode}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
