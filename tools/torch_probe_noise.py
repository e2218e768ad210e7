#!/usr/bin/env python3
"""bf16 noise floor of the PyTorch port's full-width prefill probe.

Runs ``chip_smoke.py``'s probe (random weights from seed 0, a 995-token
prompt from ``numpy.random.default_rng(0)``) through ``prefill`` on the
GPU with each kernel of the model's path switched on alone, all on, and
all off, in the model dtype, and all on and all off in f32.  For each it
prints the largest |difference| of the last position's logits from the
bf16 plain path and from the f32 plain path.  Switching one kernel for
its plain version changes only the order of f32 sums, so how far that
moves the bf16 logits is the noise floor a kernel-vs-plain probe gate
has to clear.

    PYTHONPATH=src python tools/torch_probe_noise.py [--arch mamba2-1.3b] \
        [--no-f32]

``--no-f32`` leaves out the two f32 runs, for a model whose f32 weights
do not fit the card (internlm2-20b's 79 GB).

Needs a CUDA device; prints one JSON object as its last line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import api, get_config
from repro_torch.models import ssm

PROBE_LEN = 995
# model-level kernel wrappers in ops and their plain versions
PLAIN = {"rmsnorm": lambda x, w, eps=1e-6: ref.rmsnorm_ref(x, w, eps),
         "flash_attention": ref.flash_attention_ref,
         "ssd_chunked": ssm.ssd_reference}
ON_PATH = {"dense": ("rmsnorm", "flash_attention"),
           "moe": ("rmsnorm", "flash_attention"),
           "ssm": ("rmsnorm", "ssd_chunked"),
           "hybrid": ("rmsnorm", "ssd_chunked")}


@contextlib.contextmanager
def only(kernel):
    """Every wrapper of PLAIN but ``kernel`` runs its plain version."""
    saved = {name: getattr(ops, name) for name in PLAIN}
    try:
        for name, fn in PLAIN.items():
            if name != kernel:
                setattr(ops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--no-f32", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_probe_noise: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    params = api.init(0, cfg, device="cuda")
    probe = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, PROBE_LEN), device="cuda")[None]

    def logits(c, p):
        cache = api.init_cache(c, 1, PROBE_LEN)
        out, _ = api.prefill(p, c, cache, {"tokens": probe})
        return out[0, :cfg.vocab_size]

    runs = {"kernels": logits(cfg, params),
            "plain": logits(cfg.replace(use_kernels=False), params)}
    for kernel in ON_PATH[cfg.family]:
        with only(kernel):
            runs[f"{kernel} only"] = logits(cfg, params)
    if not args.no_f32:
        cast = (lambda t: {k: cast(v) for k, v in t.items()}
                if isinstance(t, dict) else t.float())
        p32, c32 = cast(params), cfg.replace(dtype="float32")
        runs["f32 kernels"] = logits(c32, p32)
        runs["f32 plain"] = logits(c32.replace(use_kernels=False), p32)
    anchor = runs.get("f32 plain")
    table = {name: {"vs_plain": (v - runs["plain"]).abs().max().item(),
                    "vs_f32_plain": None if anchor is None else
                    (v - anchor).abs().max().item(), "top1": int(v.argmax())}
             for name, v in runs.items()}
    top = (runs["plain"] if anchor is None else anchor).abs().max().item()
    print(f"{args.arch} ({cfg.dtype}), probe of {PROBE_LEN} tokens, "
          f"max|logit| ({'bf16' if anchor is None else 'f32'} plain) "
          f"{top:.4f}, on {torch.cuda.get_device_name(0)}")
    for name, row in table.items():
        f32 = row["vs_f32_plain"]
        print(f"  {name:24s} vs bf16 plain {row['vs_plain']:.4e}   vs f32 "
              f"plain {'-' if f32 is None else f'{f32:.4e}'}   top-1 "
              f"{row['top1']}")
    print(json.dumps({"arch": args.arch, "device":
                      torch.cuda.get_device_name(0), "runs": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
