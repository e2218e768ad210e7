#!/usr/bin/env python3
"""Peak memory and step time of qwen2-1.5b training steps on the card, as
``chip_smoke.py`` phase 8(c) takes them: ``repro_torch.launch.train.run``
at bf16, batch 2 x 1024, lr 3e-4 on ``SyntheticLM``; the median host ms
of steps 2..N and the peak memory the steps allocate above what the
params and optimizer state hold before them.

Then one more step in its two halves, loss and gradients then the AdamW
update, each with its device ms (CUDA events) and peak memory above the
state, and the loss-and-gradient half once more under torch.profiler:
device ms by kernel, the heaviest first.

``--src`` names the ``src`` directory to import ``repro_torch`` from, so
two trees (this checkout and its parent unpacked with ``git archive``)
are measured in one call on one card, in turns; ``--unchunked`` raises
the chunked loss's threshold above any sequence (a tree that has one):

    python tools/torch_train_step.py [--src DIR] [--label NAME] [--steps 20]
        [--unchunked]

Needs a CUDA device; prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

TOP = 14                    # kernels listed, the heaviest first


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--unchunked", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    from repro_torch.models import api, get_config, transformer
    from repro_torch.train import optim
    from repro_torch.train.data import DataConfig, SyntheticLM
    if args.unchunked:
        transformer.XENT_CHUNK_THRESHOLD = float("inf")
    cfg = get_config("qwen2-1.5b")
    opt_cfg = optim.OptConfig(lr=3e-4, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                          global_batch=2)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, records = train.run(cfg, data_cfg, opt_cfg, args.steps,
                               device="cuda", log=lambda line: None)
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             SyntheticLM(data_cfg).global_batch(args.steps).items()}
    flat = optim.leaves(state["params"])

    def loss_and_grads():
        for t in flat:
            t.requires_grad_(True)
        try:
            return torch.autograd.grad(
                api.loss(state["params"], cfg, batch), flat)
        finally:
            for t in flat:
                t.requires_grad_(False)

    def half(fn):
        """(result, device ms, peak GiB above what was held before)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn()
        ev[1].record()
        ev[1].synchronize()
        return (out, ev[0].elapsed_time(ev[1]),
                (torch.cuda.max_memory_allocated() - before) / 2 ** 30)

    grads, grad_ms, grad_peak = half(loss_and_grads)
    _, upd_ms, upd_peak = half(lambda: optim.adamw_update(
        state, optim.unflatten(state["params"], grads), opt_cfg))
    del grads
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss_and_grads()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda kv: -kv[1])
    print(json.dumps({
        "label": args.label, "src": args.src,
        "device": torch.cuda.get_device_name(0),
        "step_ms_median_2_n": statistics.median(
            r["step_ms"] for r in records[1:]),
        "peak_gib": (peak - base) / 2 ** 30,
        "state_gib": (held - base) / 2 ** 30,
        "peak_above_state_gib": (peak - held) / 2 ** 30,
        "unchunked": args.unchunked,
        "loss_and_grad_ms": grad_ms, "loss_and_grad_peak_gib": grad_peak,
        "update_ms": upd_ms, "update_peak_gib": upd_peak,
        "loss_and_grad_device_ms": sum(ms for _, ms in kernels),
        "loss_and_grad_top_kernels_ms": [[k[:70], ms] for k, ms in
                                         kernels[:TOP]],
        "losses": [r["loss"] for r in records]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
