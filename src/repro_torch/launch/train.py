"""Training launcher (port of ``repro/launch/train.py``): AdamW steps of
one model on ``SyntheticLM`` batches, in one process on one device.

  python -m repro_torch.launch.train --arch qwen2-1.5b --device cuda \
      --steps 20 --batch 2 --seq 1024 --lr 3e-4

Without the reference's ``--mesh`` (sharded U-mode comes later) and its
checkpoint flags (the checkpoint manager and the restart loop come with
the next slice); with ``--device`` (default cuda).  Each step prints its
loss, grad norm, lr, step ms and tokens/s.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.models import api, get_config
from repro_torch.sharding import umode
from repro_torch.train import optim
from repro_torch.train.data import DataConfig, SyntheticLM


def run(cfg, data_cfg: DataConfig, opt_cfg: optim.OptConfig, steps: int,
        device="cuda", log=print):
    """Init params from seed 0 and take ``steps`` AdamW steps on
    ``SyntheticLM(data_cfg)``'s batches 0, 1, ...  Returns (state, one
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
        batch = data.global_batch(i)
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    opt_cfg = optim.OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(1, args.steps // 10))
    _, records = run(cfg, data_cfg, opt_cfg, args.steps, device=args.device)
    print(f"final loss {records[-1]['loss']:.4f} after {len(records)} steps "
          f"(first {records[0]['loss']:.4f}) on {args.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
