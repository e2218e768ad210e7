"""Serve a small model with batched requests on the PyTorch port (port of
``examples/serve_llm.py``).

  PYTHONPATH=src python examples/serve_llm_torch.py [--device cuda|cpu] \
      [--arch mamba2-1.3b-smoke]

Continuous batching over a mixed request stream (prompt lengths and
output budgets vary), with slot reuse, on the mamba2 family (an O(1)
decode state: the family built for long-context serving) by default;
``--arch`` takes any ported config.
"""
import argparse
import time

import numpy as np

from repro_torch.models import api, get_config
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b-smoke")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    params = api.init(0, cfg, device=args.device)
    engine = Engine(cfg, params, slots=4, max_seq=96, device=args.device)
    rng = np.random.default_rng(7)
    n_req = 12
    for i in range(n_req):
        plen = int(rng.integers(3, 24))
        engine.submit(Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
            max_new_tokens=int(rng.integers(4, 16))))
    t0 = time.time()
    done = engine.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    print(f"{len(done)}/{n_req} requests done, {toks} new tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s) on {engine.device}")
    print(f"engine stats: {engine.stats()}")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    assert len(done) == n_req
    return done


if __name__ == "__main__":
    main()
