"""Training launcher (port of ``repro/launch/train.py``): AdamW steps of
one model on ``SyntheticLM`` batches through the fault-tolerant loop
(``repro_torch.train.loop.run``), in one process on one device.

  python -m repro_torch.launch.train --arch qwen2-1.5b --device cuda \
      --steps 20 --batch 2 --seq 1024 --lr 3e-4 \
      --ckpt-dir /path/to/ckpt --ckpt-every 20

The reference's flags, ``--mesh`` (a shape of ones: the train step is
single-device until LM sharding), ``--ckpt-dir`` and ``--ckpt-every``
among them, and ``--device`` (default cuda).  As in the reference a run
resumes from the latest checkpoint in ``--ckpt-dir``.  Each step prints
its loss and step ms; the last line has the final loss, the median ms
of the steps after the first and tokens/s.

``run`` takes AdamW steps without the loop, and so without checkpoints,
for timing a step alone.
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.models import api, get_config
from repro_torch.sharding import umode
from repro_torch.train import optim
from repro_torch.train.data import DataConfig, SyntheticLM, model_batch
from repro_torch.train.loop import LoopConfig, run as loop_run
from .mesh import make_mesh


def run(cfg, data_cfg: DataConfig, opt_cfg: optim.OptConfig, steps: int,
        device="cuda", log=print):
    """Init params from seed 0 and take ``steps`` AdamW steps on
    ``SyntheticLM(data_cfg)``'s batches 0, 1, ... (an enc-dec's or VLM's
    with their frames or patches, ``data.model_batch``).  Returns (state, one
    record per step: step, loss, grad_norm, lr, step_ms, tokens_per_s).
    A step's time runs from handing the numpy batch to the step to its
    loss on the host (which waits for the device)."""
    device = resolve_device(device)
    state = optim.init_state(api.init(0, cfg, device=device))
    step_fn = umode.make_train_step(cfg, opt_cfg)
    data = SyntheticLM(data_cfg)
    tokens = data_cfg.global_batch * data_cfg.seq_len
    records = []
    for i in range(steps):
        batch = model_batch(cfg, data, i)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss = float(m["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) * 1e3
        rec = {"step": state["step"], "loss": loss,
               "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
               "step_ms": ms, "tokens_per_s": tokens / ms * 1e3}
        records.append(rec)
        log(f"step {rec['step']:4d}  loss {loss:.4f}  grad_norm "
            f"{rec['grad_norm']:.3f}  lr {rec['lr']:.2e}  {ms:.1f} ms  "
            f"{rec['tokens_per_s']:.0f} tok/s")
    return state, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 1x1")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = make_mesh((d, m), ("data", "model"), device=args.device)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    report = loop_run(
        cfg, mesh, data_cfg,
        opt_cfg=optim.OptConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(1, args.steps // 10)),
        loop_cfg=LoopConfig(total_steps=args.steps,
                            ckpt_every=args.ckpt_every,
                            ckpt_dir=args.ckpt_dir, log_every=1))
    # the first step compiles and warms up
    ms = statistics.median(report.step_s[1:]) * 1e3 \
        if len(report.step_s) > 1 else float("nan")
    print(f"final loss {report.final_loss:.4f} after {report.final_step} "
          f"steps (restarts={report.restarts}) on {args.device}; median "
          f"step {ms:.1f} ms, {args.batch * args.seq / ms * 1e3:.0f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
