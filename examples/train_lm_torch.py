"""End-to-end driver on the PyTorch port: train the reference's
``config_100m`` qwen2-family LM (32.5M params by
``ModelConfig.param_count``) through the fault-tolerant loop (port of
``examples/train_lm.py``).

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \
      [--device cuda|cpu]

The config is the qwen2-1.5b architecture scaled down (8 layers,
d_model=512, GQA kv=2, SwiGLU, QKV bias, vocab 8192), in f32 with the
materialised attention, as in the reference.  Checkpoints go to a fresh
temporary directory every 100 steps.  Loss on the synthetic Markov
stream should drop well below the uniform baseline ln(V).
"""
import argparse
import math
import tempfile

from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_config
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optim import OptConfig


def config_100m():
    return get_config("qwen2-1.5b").replace(
        name="qwen2-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=1536, vocab_size=8192,
        dtype="float32", attn_impl="ref")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config_100m()
    n = cfg.param_count()
    print(f"training {cfg.name}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch} x seq {args.seq} on "
          f"{args.device}")
    mesh = make_mesh((1, 1), ("data", "model"), device=args.device)
    with tempfile.TemporaryDirectory(prefix="train_lm_ckpt_") as ckpt_dir:
        report = run(
            cfg, mesh,
            DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       global_batch=args.batch, structure=31),
            opt_cfg=OptConfig(lr=3e-4, total_steps=args.steps,
                              warmup_steps=args.steps // 20),
            loop_cfg=LoopConfig(total_steps=args.steps, ckpt_every=100,
                                ckpt_dir=ckpt_dir, log_every=20))
    uniform = math.log(cfg.vocab_size)
    print(f"uniform baseline {uniform:.3f}; "
          f"first loss {report.losses[0]:.3f}; "
          f"final loss {report.final_loss:.3f}")
    assert report.final_loss < report.losses[0]
    return report


if __name__ == "__main__":
    main()
