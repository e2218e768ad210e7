"""Serving launcher: continuous-batching engine over synthetic requests
(port of ``repro/launch/serve.py``, plus ``--device``).

  python -m repro_torch.launch.serve --arch qwen2-1.5b --device cuda \
      --requests 16 --slots 4 --max-seq 2048 --max-new 32

``--arch`` takes any ported config (``repro_torch.models.list_archs()``),
e.g. mamba2-1.3b.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.models import api, get_config
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b-smoke")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = api.init(0, cfg, device=args.device)
    engine = Engine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                    device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        n = int(rng.integers(4, 16))
        engine.submit(Request(uid=i,
                              prompt=rng.integers(0, cfg.vocab_size, n),
                              max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {engine.device}; "
          f"stats={engine.stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
