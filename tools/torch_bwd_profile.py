#!/usr/bin/env python3
"""Device time of each launch of the port's backward kernels, by kernel.

Calls, at the shapes of a qwen2-1.5b training step on the card:

* ``flash_attention_bwd`` at B=2, S=1024, H=12, K=2, hd=128, bf16 and
  f32, on the kernel forward's o and log-sum-exp;
* ``rmsnorm_bwd`` at 2048 x 1536, plain and residual, bf16 and f32, and
  beside it autograd's backward of ``F.rms_norm`` (after the eager add
  for the residual form) on the same inputs;

and at the shapes of a mamba2-1.3b training step:

* ``ssd_chunk_bwd`` at R=8, H=64, Q=256, P=64, N=128, B and C shared by
  the heads;
* ``gated_rmsnorm_bwd`` at 2048 x 4096, bf16 and f32;

each ``--reps`` times under torch.profiler, and prints per case the
device ms per call of every kernel it launched and their sum.  ``--src``
names the ``src`` directory of the tree to import ``repro_torch`` from,
so the same cases can be taken of two trees (this checkout and its
parent unpacked with ``git archive``) in one run on one card:

    python tools/torch_bwd_profile.py [--src DIR] [--reps 20] [--only S]

``--only`` keeps the cases whose name contains S.

Needs a CUDA device; the last line is one JSON object with every case.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys


def launch_ms(fn, reps: int) -> dict:
    """{kernel name: device ms per call} of ``fn``'s launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    out = {"src": args.src, "device": torch.cuda.get_device_name(0),
           "cases": []}

    def show(case, fn):
        if args.only not in case:
            return
        times = launch_ms(fn, args.reps)
        row = {"case": case, "launch_ms": times,
               "total_ms": sum(times.values())}
        out["cases"].append(row)
        print(f"{case}: total {row['total_ms']:.4f} ms", flush=True)
        for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
            print(f"    {ms:.4f}  {name[:110]}")

    B, S, H, K, hd = 2, 1024, 12, 2, 128
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q, do = randn(B, S, H, hd, dt=dt), randn(B, S, H, hd, dt=dt)
        k, v = randn(B, S, K, hd, dt=dt), randn(B, S, K, hd, dt=dt)
        o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
        show(f"flash_attention_bwd B={B},S={S},hd={hd} {dtype}",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))

    rows, d = 2048, 1536
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x, dy, dh = (randn(rows, d, dt=dt) for _ in range(3))
        w = (1 + 0.1 * randn(d, dt=torch.float32)).to(dt)
        xg, rg, wg = (t.detach().requires_grad_() for t in (x, x, w))
        h = xg + rg
        y_plain = F.rms_norm(xg, (d,), wg, 1e-6)
        y_resid = F.rms_norm(h, (d,), wg, 1e-6)
        show(f"rmsnorm_bwd rows={rows},d={d} {dtype}",
             lambda: rms.rmsnorm_bwd(x, w, dy, 1e-6))
        show(f"autograd of F.rms_norm rows={rows},d={d} {dtype}",
             lambda: torch.autograd.grad(y_plain, (xg, wg), dy,
                                         retain_graph=True))
        show(f"add_rmsnorm_bwd rows={rows},d={d} {dtype}",
             lambda: rms.rmsnorm_bwd(x, w, dy, 1e-6, dh=dh))
        show(f"autograd of x + r; F.rms_norm rows={rows},d={d} {dtype}",
             lambda: torch.autograd.grad(
                 (h, y_resid), (xg, rg, wg), (dh, dy), retain_graph=True))

    from repro_torch.kernels import ssd
    R, H, Q, P, N = 8, 64, 256, 64, 128
    x, dy = randn(R, H, Q, P, dt=torch.float32), randn(R, H, Q, P,
                                                      dt=torch.float32)
    dt = F.softplus(randn(R, H, Q, dt=torch.float32))
    cs = torch.cumsum(dt * -torch.exp(randn(H, dt=torch.float32))[:, None],
                      dim=-1)
    Bm, Cm = (randn(R, 1, Q, N, dt=torch.float32).expand(R, H, Q, N)
              for _ in range(2))
    dS = randn(R, H, N, P, dt=torch.float32)
    show(f"ssd_chunk_bwd R={R},H={H},Q={Q},P={P},N={N} float32",
         lambda: ssd.ssd_chunk_bwd(x, dt, cs, Bm, Cm, dy, dS))

    rows, d = 2048, 4096
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x, dy = randn(rows, d, dt=dt), randn(rows, d, dt=dt)
        z = (2 * randn(rows, d, dt=torch.float32)).to(dt)
        w = (1 + 0.1 * randn(d, dt=torch.float32)).to(dt)
        show(f"gated_rmsnorm_bwd rows={rows},d={d} {dtype}",
             lambda: rms.gated_rmsnorm_bwd(x, z, w, dy, 1e-6))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
