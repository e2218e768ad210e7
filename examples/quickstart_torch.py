"""Quickstart on the PyTorch port: the public API in one file (port of
``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

1. pick an assigned architecture (reduced config), init params;
2. train a few steps with the fault-tolerant loop (AdamW, checkpoints);
3. serve a few requests with the continuous-batching engine;
4. analysis: trace the loss on the ``meta`` device (the kernel path,
   nothing allocated) into an ``HloCost``, replay it on the MGSim system
   model and print the roofline.

Steps 2 and 3 run on ``--device`` (default cuda); step 4 needs no
device.  The simulated time is the system model's (its default chip is
a TPU v5e ``ChipSpec``), not a measurement.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import (SINGLE_POD, analyze, build_terms,
                              cost_analysis, simulate)
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, get_config
from repro_torch.serve import Engine, Request
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optim import OptConfig

ARCH = "qwen2-1.5b-smoke"


def main(device="cuda"):
    cfg = get_config(ARCH)
    mesh = make_mesh((1, 1), ("data", "model"), device=device)

    # ---- 2. train -------------------------------------------------------
    print(f"== training {ARCH} on {device} ==")
    # fresh checkpoint dir: a leftover checkpoint at step 20 would resume
    # past the loop and train zero steps
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt_dir:
        report = run(cfg, mesh,
                     DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=4),
                     opt_cfg=OptConfig(lr=1e-3, total_steps=20,
                                       warmup_steps=2),
                     loop_cfg=LoopConfig(total_steps=20, ckpt_every=10,
                                         ckpt_dir=ckpt_dir, log_every=5))
    print(f"loss {report.losses[0]:.3f} -> {report.final_loss:.3f}")

    # ---- 3. serve -------------------------------------------------------
    print("== serving ==")
    params = api.init(0, cfg, device=device)
    engine = Engine(cfg, params, slots=2, max_seq=64, device=device)
    for i in range(4):
        engine.submit(Request(uid=i,
                              prompt=np.arange(3 + i, dtype=np.int32),
                              max_new_tokens=5))
    done = engine.run_until_drained()
    print(f"served {len(done)} requests; first output: {done[0].output}")

    # ---- 4. analyze -----------------------------------------------------
    print("== machine-level analysis (MGSim) ==")
    batch = {k: torch.zeros((4, 32), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    cost = analyze(api.loss, api.init(0, cfg, device="meta"), cfg, batch)
    terms = build_terms(f"{ARCH}/quickstart", "(1,1)", 1,
                        cost_analysis(cost), cost, SINGLE_POD)
    rep = simulate(cost=cost, spec=SINGLE_POD, device_limit=1)
    print(f"flops={terms.flops_per_device:.3g} "
          f"hbm={terms.hbm_bytes_per_device:.3g}B "
          f"dominant={terms.dominant}")
    print(f"simulated step time on a v5e chip: {rep.time_s * 1e3:.3f} ms "
          f"(util {rep.compute_util:.2f})")
    return report, done, terms, rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
