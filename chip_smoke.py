#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises (and so exits non-zero) on failure:

1. build  — compile every CUDA kernel of the port from this checkout's
   sources (one nvcc per source, in parallel), print ptxas's report and
   count the tensor-core instructions (HGMMA, HMMA) in each library's
   SASS with cuobjdump; flash_attention and flash_attention_bwd must hold
   HGMMA and ssd HMMA;
2. kernels — hold each kernel against its plain PyTorch version, bf16 and
   f32, at the serving, training and MGMark paths' shapes, and time the
   kernel, the plain version and one library call computing the same
   function (for attention, ``scaled_dot_product_attention`` pinned to
   each backend the build offers, the fastest recorded, and for its
   backward that call's forward + backward less its forward; for the
   fused norms, the add or the gate and ``F.rms_norm`` as separate calls,
   and for the norms' backward autograd of them less their forward; none
   for SSD and its backward); each
   backward case also prints the device time of each of its launches
   (torch.profiler), and autograd's beside the norms'; the
   forward's log-sum-exp is held to its plain version; the fused norms'
   h must equal the eager add bit for bit, and BS's whole sort on the
   kernels must equal ``torch.sort`` (timed beside it);
3. serve  — qwen2-1.5b at full width (bf16, 28 layers, random weights
   from a seed): ``api.loss(...).backward()`` on the kernel path must run
   the backward kernels and give every param a finite gradient,
   kernel-path vs plain-path prefill logits on a 995-token probe, then
   16 requests through ``repro_torch.serve.Engine`` with the kernels'
   launch counters read around that run (no backward launched and no
   log-sum-exp stored while serving);
4. f32    — the full-width model in f32: greedy tokens of the kernel path
   and the plain path must be identical;
5. serve  — phase 3 for mamba2-1.3b at full width (bf16, 48 layers): the
   SSD kernel must run once per layer of every prefill, and
   ``api.loss(...).backward()`` on the kernel path must run the SSD and
   gated-norm backward kernels once a layer and give every param a
   finite gradient;
6. f32    — phase 4 for mamba2-1.3b;
7. mgmark — the seven MGMark workloads in U-mode and D-mode on a 4-shard
   mesh on the card at ``default_size(4)`` (``repro_torch.launch.mgmark``):
   each correct against its oracle, D-mode collective bytes (counted and
   traced) equal to the count from the shapes, U-mode's traced bytes (the
   collectives DTensor issues) equal to the CPU tests' pins, the stencil
   and bitonic kernels launched as many times as the SC and BS programs
   call them and as the traces hold, the simulated fields finite, device
   ms per run; each run's trace SIMULATED on 4 chips with the reference's
   default (v5e) ChipSpec and with the H100's datasheet, the D-mode
   simulated/bound ratios and the paper's four lessons printed;
8. train  — qwen2-1.5b at full width: (a) f32 gradients of ``api.loss``
   (batch 1 x 1024, all 28 layers) on the kernel path against the plain
   path, each param's within TRAIN_F32_TOL of its max |g|; (b) the bf16
   kernel path's gradients held to the f32 plain path's on two batches,
   no farther than the bf16 plain path's plus the family's margins
   (TRAIN_BF16_MARGINS), and planted faults that must fail that gate
   (TRAIN_BF16_CONTROLS); (c) 20 AdamW steps at
   bf16, batch 2 x 1024, on ``SyntheticLM`` through
   ``repro_torch.launch.train.run``: finite, falling loss, the kernels
   launched as many times as the layer count says, step ms, tokens/s,
   device busy and idle share (torch.profiler) and peak memory;
9. loop   — qwen2-1.5b at full width: (a) ``repro_torch.train.loop.run``
   for 8 steps at phase 8's shape, a checkpoint every 3 (async, the last
   kept), a failure injected before step 5 and a re-mesh before step 7:
   one restart, one re-mesh, the state restored at step 3 equal to the
   saved one (per-leaf checksums taken on the card) and the replayed
   step-3 and step-4 losses equal to the first ones, bit for bit, the
   kernels launched as many times as the steps run say; save, write and
   restore seconds, bytes written and step ms; (b) one whole train step traced on the
   meta device (``repro_torch.core.analyze``): one trace op per kernel
   call of a step, matrix-product FLOPs equal to the count from the
   config (the chunked loss's recomputed unembedding included), and the
   step SIMULATED on one chip with the reference's v5e
   ChipSpec and with the H100's datasheet, beside phase 8's measured
   step; (c) ``examples/quickstart_torch.py`` end to end on the card;
10. mamba — phases 8 and 9 for mamba2-1.3b at full width (48 layers,
   through the SSD and gated-norm backward kernels): (a) f32 gradients
   against the plain path, (b) bf16 gradients held to the f32 plain
   path, (c) 20 AdamW steps through ``launch.train.run`` with their step
   ms, tokens/s, device busy, idle share and peak memory, (d) ``loop.run``
   for 6 steps with a checkpoint at 3 and a failure before step 5, the
   replayed losses equal to the first ones bit for bit, (e) one train step traced on meta, one op
   per kernel call, SIMULATED beside (c)'s measured step;
11. sim   — the simulator's parallel engine on the card's host, in two
   child interpreters that create no CUDA context (the procs executor
   forks): phase 9(b)'s train step and phase 7's 14 MGMark programs
   traced on meta, then (a) each trace simulated on H100 datasheet
   ChipSpecs under serial and under batch, lookahead and bounded x the
   threads and procs executors, MGMark's 4-chip traces on the analytic
   and the event fabric, every summary equal to serial's on the same
   fabric, with the wall seconds of each scheduler x executor and the
   host's CPU count, and the same for the diverged ring of
   ``benchmarks/engine_scalability.py`` on the port's engine (32 nodes x
   1200 ticks, 4 workers); (b) the serving simulator: qwen2-1.5b at full width,
   one tenant on one H100 with phase 3's traffic, and a two-failure
   failover scenario, under serial and bounded x both executors on both
   fabrics, summaries equal to serial's, the SIMULATED tokens/s beside
   phase 3's measured ones; (c) ``tools/torch_sweep.py``'s quick grid
   inline and on 2 workers: equal rows, the rerun's plans all from the
   plan cache.

Before the last line it prints ``{"kernels": [...]}`` and the card's name
and power limit from nvidia-smi; the last line is ``{"ok": true,
"device": {...}}``.  Every case, the serving and training numbers and
the MGMark rows and simulated numbers, phase 9's ``loop``,
``analysis`` and ``quickstart`` numbers and phase 11's ``sim`` numbers
also go to ``build/chip_smoke.json``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM datasheet peak
# dense peaks: bf16 and TF32 tensor cores, f32 CUDA cores; 3xTF32 does
# three TF32 products for each f32 one
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,
                  "tf32x3": 495e12 / 3}
# the tensor-core instructions each redesigned kernel's SASS must hold
TENSOR_CORE_SASS = {"flash_attention": "HGMMA",
                    "flash_attention_bwd": "HGMMA", "ssd": "HMMA",
                    "ssd_bwd": "HMMA"}
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")
TOL = {"float32": (2e-5, 1e-4), "bfloat16": (3e-2, 3e-2)}   # atol, rtol
# the backward kernels: f32 sums of up to G * S products in another order;
# bf16 P and dS rounded to bf16 before their products (the tensor-core
# kernels' A operands) and one rounding of each output.  The forward's
# log-sum-exp: f32 in both kernels.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
LSE_TOL = (1e-4, 1e-4)
FLASH_SEQS = (1, 77, 128, 995, 2047)
# flash backward, (B, S, H, K, hd): qwen2-1.5b's training shape (the main
# one), a ragged prompt, a small head width
FLASH_BWD_CASES = ((2, 1024, 12, 2, 128), (1, 995, 12, 2, 128),
                   (2, 256, 4, 2, 16))
RMS_BWD_SHAPE = (2048, 1536)    # qwen2-1.5b's training batch of 2 x 1024
RMS_ROWS = (1, 4, 995, 2047)
RMS_ROWS_MAMBA = (4, 995)       # at mamba2-1.3b's d_inner, 4096
# the fused norms, (d, rows): the residual add in front of qwen2-1.5b's
# (1536) and mamba2-1.3b's (2048) pre-norms; mamba2-1.3b's gate (4096)
FUSED_ROWS = (1, 4, 995)
ADD_NORM_DIMS = (1536, 2048)
GATED_NORM_DIM = 4096
# SSD chunk kernel at mamba2-1.3b's heads (H=64, P=64, N=128), (label, R, Q):
# the 1000-token prompt (the main shape), a 77-token prompt, one token,
# and a 2047-token prompt
SSD_CASES = (("R=4,Q=256", 4, 256), ("R=1,Q=77", 1, 77), ("R=1,Q=1", 1, 1),
             ("R=8,Q=256", 8, 256))
SSD_TOL = (1e-4, 1e-4)          # tests/test_kernels.py's for this kernel
# the SSD backward at mamba2-1.3b's heads, (label, R, Q, B/C shared by the
# heads): phase 10's training shape, batch 2 x 1024 (the main one), a
# short chunk, one token, and B and C per head; every output within
# 1e-4 of its max |value| (f32 sums of up to Q products in another order)
SSD_BWD_CASES = (("R=8,Q=256", 8, 256, True), ("R=1,Q=77", 1, 77, True),
                 ("R=1,Q=1", 1, 1, True), ("R=2,Q=256,per-head", 2, 256,
                                           False))
SSD_BWD_TOL = 1e-4
GATED_BWD_SHAPE = (2048, 4096)  # mamba2-1.3b's training rows, d_inner
# the times of the two backward kernels before their redesign on the
# tensor cores and for bandwidth, at their main shapes (PERF.md section
# 6, on an H100 80GB HBM3 at 700 W), printed beside this run's: a
# reference, not a measurement of this run, so kept out of the records
PREVIOUS_MS = {("ssd_chunk_bwd", "R=8,Q=256", "float32"): 1.8390,
               ("gated_rmsnorm_bwd", "rows=2048,d=4096", "bfloat16"): 0.0624,
               ("gated_rmsnorm_bwd", "rows=2048,d=4096", "float32"): 0.0792}
# stencil2d, (H, W, K, dtype): SC's 4096^2 image (the main shape), bf16,
# K=5, and a ragged image; f32 atol 1e-5 (the same products in the same
# order, the kernel's contracted into FMAs)
STENCIL_CASES = ((4096, 4096, 3, "float32"), (1024, 1024, 3, "bfloat16"),
                 (4096, 4096, 5, "float32"), (1000, 1000, 3, "float32"))
STENCIL_TOL = {"float32": (1e-5, 0.0), "bfloat16": (3e-2, 3e-2)}
# bitonic_stage, (L, size, dist, offset, dtype): BS's 131072 (U-mode's
# length; the first is the main shape) at three stages, a D-mode shard's
# stage with its offset, int32 keys, and a card-filling 2^24; exact
BITONIC_CASES = ((131072, 2, 1, 0, "float32"),
                 (131072, 4096, 1024, 0, "float32"),
                 (131072, 131072, 32, 0, "float32"),
                 (32768, 65536, 512, 32768, "float32"),
                 (131072, 64, 16, 0, "int32"),
                 (2 ** 24, 2 ** 24, 1024, 0, "float32"))
# bitonic_block, (L, size, offset, dtype), tile 2048: BS's 131072 first
# launch (phases 2..2048, 66 stages; the main shape), its last phase's
# tail, a D-mode shard's tail with its offset, int32 keys, and a
# card-filling 2^24; exact
BITONIC_BLOCK_CASES = ((131072, 2048, 0, "float32"),
                       (131072, 131072, 0, "float32"),
                       (32768, 65536, 32768, "float32"),
                       (131072, 2048, 0, "int32"),
                       (2 ** 24, 2048, 0, "float32"),
                       (2 ** 24, 2 ** 24, 0, "float32"))
# MGMark on a 4-shard mesh at default_size(4): D-mode collective bytes per
# device from the shapes (aes none; km one (16,32)+(16,) f32 psum; fir 15
# f32; sc 2 rows of 4096 f32; gd 8 psums of 256 f32; mt (4,2048,2048)
# f32; bs 3 cross-shard stages of 32768 f32), and the kernels each
# program must launch (patterns/bs.py's _steps: a sort of 131072 takes
# 21 stages with dist >= 2048 and 7 block launches; a D-mode shard of
# 32768 takes 18 stages with 2048 <= dist < 32768 and 7 block launches)
MGMARK_SHARDS = 4
MGMARK_BYTES = {"aes": 0, "km": 2112, "fir": 60, "sc": 32768, "gd": 8192,
                "mt": 67108864, "bs": 393216}
# U-mode: the collectives DTensor issues for the global program (traced
# on meta; pinned on the CPU by tests/test_torch_patterns.py): km an
# all-reduce of the counts (16 f32) and one of the sums (16 x 32 f32); fir
# an all-gather of the whole signal (262144 f32) for the pad; sc and bs
# an all-gather of the whole image (4096^2 f32) and array (131072 f32)
# for the kernels; gd 8 all-reduces of 256 f32; mt an all-to-all of a
# shard's (2048, 8192) f32
MGMARK_UMODE_BYTES = {"aes": 0, "km": 2112, "fir": 1048576, "sc": 67108864,
                      "gd": 8192, "mt": 67108864, "bs": 524288}
MGMARK_LAUNCHES = {("sc", "umode"): {"stencil2d": 1},
                   ("sc", "dmode"): {"stencil2d": 4},
                   ("bs", "umode"): {"bitonic_stage": 21, "bitonic_block": 7},
                   ("bs", "dmode"): {"bitonic_stage": 72,
                                     "bitonic_block": 28}}
PROBE_LEN = 995
PROBE_ATOL = 0.1                # bf16 logits: a few ulps at |logit| < 8
F32_PROBE_ATOL = 1e-3           # f32 logits: f32 sums in another order
# mamba2-1.3b's bf16 probe cannot be held to PROBE_ATOL directly: over its
# 48 layers of random weights, a change in the order of any f32 sum (the
# rmsnorm kernel's alone) moves its bf16 logits by about 0.18, and the
# plain path itself is about 0.2 from the same weights in f32
# (tools/torch_probe_noise.py).  Its probe holds both bf16 paths to the
# f32 plain path instead: the kernel path may be at most PROBE_ATOL
# farther from it than the plain path is, and in f32 the kernel path
# must agree with the plain path within F32_PROBE_ATOL.
F32_ANCHORED_PROBE = ("mamba2-1.3b",)
# phase 8 (and 10 for mamba).  (a) f32 gradients, kernel path vs plain
# path, per param: max |diff| <= TRAIN_F32_TOL * max |g| (f32 sums in
# another order, 28 or 48 layers deep).  (b) bf16 gradients carry bf16's
# own rounding through the layers of random weights, so they are held,
# as mamba's probe is, to the f32 plain gradients, on the batches of
# each of TRAIN_GRAD_SEEDS: per param, the kernel path's distance to
# them may exceed the bf16 plain path's by at most a margin, both in
# max |diff| / max |g| and in ||diff|| / ||g||.  The margins are the
# model family's (TRAIN_BF16_MARGINS: max-abs, L2).  At mamba2-1.3b's 48
# layers the max-abs distance, an extreme over up to millions of noisy
# elements, moves by up to 0.05 between two batches for either path,
# while the L2 ones of the two paths agree within about 0.006; a bf16
# rounding of the SSD backward's outputs, or an fp8 rounding of the
# gated norm's, moves the L2 excess by several times that (PERF.md §6).
# So the L2 margin sits between them, and each planted fault of
# TRAIN_BF16_CONTROLS (a backward launcher whose outputs are rounded)
# must fail the gate.
# (c) AdamW steps: lr 3e-4 (OptConfig's default), the launcher's warmup
# (steps // 10) and cosine schedule.
TRAIN_ARCH = "qwen2-1.5b"
MAMBA_ARCH = "mamba2-1.3b"
TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ = 1, 1024
TRAIN_GRAD_SEEDS = (1, 2)
TRAIN_F32_TOL = 1e-4
TRAIN_BF16_MARGINS = {"dense": (0.05, 0.01), "ssm": (0.1, 0.01)}
# family -> (label, launcher module in repro_torch.kernels, launcher,
# the rounding of its outputs)
TRAIN_BF16_CONTROLS = {
    "ssm": (("ssd_chunk_bwd's outputs rounded to bf16", "ssd",
             "ssd_chunk_bwd", "bf16"),
            ("gated_rmsnorm_bwd's outputs rounded to fp8 e4m3", "rmsnorm",
             "gated_rmsnorm_bwd", "fp8"))}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 2, 1024, 3e-4
# phase 9.  (a) loop.run at phase 8's shape: a checkpoint every 3 steps,
# the last one kept (one is 17.8 GB: bf16 params and f32 moments; two
# exist while the next is written), written asynchronously; a node
# failure injected before step 5 (restore from step 3, replay 3..4) and
# an elastic re-mesh onto a fresh 1x1 mesh before step 7.  (b) the H100
# SXM datasheet as the simulator's ChipSpec (dense bf16 tensor cores,
# f32 CUDA cores, HBM3), beside the reference's default (a TPU v5e).
LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_KEEP = 8, 3, 1
LOOP_FAULT_STEP, LOOP_REMESH_STEP = 5, 7
# phase 10(d): mamba's loop, shorter and with no re-mesh (a checkpoint
# is 14.5 GB): steps 0..4, a checkpoint at 3, a failure before step 5,
# steps 3..5 again
MAMBA_LOOP_STEPS = 6
H100_CHIP = dict(name="h100-sxm", peak_bf16_flops=989e12,
                 peak_f32_flops=67e12, hbm_bandwidth=HBM_BYTES_PER_S,
                 hbm_capacity=80 * 10 ** 9)
# device time of a training step by kernel group: (group, substrings of
# the kernels' names), first match wins
TRAIN_KERNEL_GROUPS = (
    ("flash_attention_bwd", ("flash_bwd",)),
    ("flash_attention", ("flash_fwd",)),
    ("ssd_chunk_bwd", ("ssd_bwd",)),
    ("ssd_chunk_kernel", ("ssd_chunk_kernel",)),
    ("rmsnorm fwd+bwd", ("rmsnorm",)),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
    ("softmax/loss", ("softmax", "nll_loss", "logsumexp")),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
    ("copy/fill", ("Memcpy", "Memset", "copy", "fill")))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed between two events, so the host's launch
    overhead (which exceeds a small kernel's run time) is left out."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(fn, reps: int = 10) -> dict:
    """{kernel name: device ms per call} of each kernel ``fn`` launches,
    from torch.profiler over ``reps`` calls."""
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


def print_launches(label: str, times: dict) -> None:
    print(f"    {label} launches: " + "; ".join(
        f"{name[:60]} {ms:.4f} ms" for name, ms in
        sorted(times.items(), key=lambda kv: -kv[1])), flush=True)


def ssd_f64(x, dt, cs, Bm, Cm):
    """The SSD chunk function (``ref.ssd_chunk_ref``) computed in f64."""
    import torch
    x, dt, cs, Bm, Cm = (t.double() for t in (x, dt, cs, Bm, Cm))
    Q = x.shape[2]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask, torch.exp(cs[..., :, None] - cs[..., None, :]),
                        0.0)
    att = torch.einsum("rhin,rhjn->rhij", Cm, Bm) * decay * dt[..., None, :]
    w = torch.exp(cs[..., -1:] - cs) * dt
    return (torch.einsum("rhij,rhjp->rhip", att, x),
            torch.einsum("rhqn,rhq,rhqp->rhnp", Bm, w, x))


def kbound(cost, dtype: str):
    """``bound`` of a ``repro_torch.kernels.cost`` (operations, bytes)."""
    ops, nbytes = cost
    return bound(nbytes, ops, dtype)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
def phase_build():
    """Returns {library: {"HGMMA": n, "HMMA": n}} from its SASS, or {}
    where the toolkit has no cuobjdump."""
    import shutil
    from repro_torch.kernels import build
    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    info = build.build()
    print(f"  built {sorted(info)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for name, rec in sorted(info.items()):
        print(f"== {name}.cu -> {rec['path'].name}")
        for line in rec["log"].splitlines():
            if "ptxas" in line or "spill" in line:
                print("  " + line.strip())
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(build.nvcc()).with_name("cuobjdump"))
    if not pathlib.Path(tool).exists():
        print("  cuobjdump not found: tensor-core SASS not counted")
        return {}
    sass = {}
    for name, rec in sorted(info.items()):
        text = subprocess.run([tool, "-sass", str(rec["path"])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        sass[name] = {op: len(re.findall(rf"\s{op}[.\s]", text))
                      for op in ("HGMMA", "HMMA")}
    print(f"  tensor-core instructions in the SASS: {sass}")
    for name, op in TENSOR_CORE_SASS.items():
        check(sass[name][op] > 0, f"{name}: no {op} in its SASS")
    return sass


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd
    print("== phase 2: kernels vs their plain versions", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.kernels import bitonic, cost, ops, stencil
    cases = {"flash_attention": [], "rmsnorm": [], "add_rmsnorm": [],
             "gated_rmsnorm": [], "ssd_chunk_kernel": [], "stencil2d": [],
             "bitonic_stage": [], "bitonic_block": [],
             "flash_attention_bwd": [], "rmsnorm_bwd": [],
             "add_rmsnorm_bwd": [], "gated_rmsnorm_bwd": [],
             "ssd_chunk_bwd": []}

    def record(name, shape, dtype, got, want, fn, plain_fn, lib_fn, b,
               tol=None, per_max=False, **extra):
        """got/want: a tensor or a tuple of tensors; lib_fn None where no
        one PyTorch call computes the function, or {label: fn} of which
        the fastest that runs is recorded, or {label: ms or None} of
        times taken already.  per_max: each output's atol is tol's atol
        times that output's max |want|."""
        ms, plain_ms = time_ms(fn), time_ms(plain_fn)
        if isinstance(lib_fn, dict):
            extra["library_ms_by_backend"] = by = {}
            for label, f in lib_fn.items():
                if f is None or isinstance(f, float):
                    by[label] = f
                    continue
                try:
                    by[label] = time_ms(f)
                except RuntimeError:        # the build offers no such kernel
                    by[label] = None
            ran = {k: v for k, v in by.items() if v is not None}
            extra["library"] = min(ran, key=ran.get) if ran else None
            lib_ms = ran[extra["library"]] if ran else None
        else:
            lib_ms = None if lib_fn is None else time_ms(lib_fn)
        atol, rtol = tol or TOL[dtype]
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        errs = [(g.float() - w.float()).abs() for g, w in pairs]
        scale = [w.float().abs().max().item() if per_max else 1.0
                 for _, w in pairs]
        ok = all(bool((e <= atol * m + rtol * w.float().abs()).all())
                 for e, m, (_, w) in zip(errs, scale, pairs))
        if per_max:
            extra["max_err_over_max_value"] = max(
                e.max().item() / max(m, 1e-30) for e, m in zip(errs, scale))
        row = {"shape": shape, "dtype": dtype,
               "max_abs_err": max(e.max().item() for e in errs),
               "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
               **extra}
        cases[name].append(row)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        if "library" in extra:
            lib += f" ({extra['library']}; {extra['library_ms_by_backend']})"
        if "max_abs_err_vs_f64" in extra:
            lib += f"  vs f64 {extra['max_abs_err_vs_f64']}"
        if (name, shape, dtype) in PREVIOUS_MS:
            lib += (f"  previous {PREVIOUS_MS[name, shape, dtype]:.4f} "
                    f"(before the redesign)")
        print(f"  {name:16s} {shape:15s} {dtype:8s} err "
              f"{row['max_abs_err']:.3e} (atol {atol}, rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f}  library {lib}  bound {b[0]:.5f} ({b[1]})",
              flush=True)
        check(ok, f"{name} {shape} {dtype}: kernel disagrees with its plain "
                  f"version (max abs err {row['max_abs_err']:.3e})")

    def sdpa(qt, kt, vt, backend):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        def call():
            with sdpa_kernel(getattr(SDPBackend, backend)):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        return call

    H, K, hd = 12, 2, 128                       # qwen2-1.5b's heads
    for S in FLASH_SEQS:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn(1, S, H, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(1, S, K, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(1, S, K, hd, generator=gen, device="cuda").to(dt)
            got = fa.flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_ref(q, k, v, causal=True)
            torch.cuda.synchronize()
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            record("flash_attention", f"S={S}", dtype, got, want,
                   lambda: fa.flash_attention(q, k, v, causal=True),
                   lambda: ref.flash_attention_ref(q, k, v, True),
                   {name: sdpa(qt, kt, vt, name) for name in SDPA_BACKENDS},
                   kbound(cost.flash_attention(q, k), dtype))

    # The flash backward at qwen2-1.5b's heads, on the kernel forward's o
    # and log-sum-exp (held to the plain LSE first).  Bound: 2.5x the
    # forward's causal operations (recomputed S, dP, dV, dQ, dK against
    # S and P V) at the dtype's peak; bytes q, k, v, o, dO and lse read
    # once, dq, dk, dv written once.  Library: SDPA's forward + backward
    # less its forward, per backend, the fastest kept.
    def sdpa_times(q, k, v, do):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def fwd(backend):
            with sdpa_kernel(getattr(SDPBackend, backend)):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        times = {}
        for backend in SDPA_BACKENDS:
            try:
                both = time_ms(lambda: torch.autograd.grad(
                    fwd(backend), (qt, kt, vt), dot))
                times[backend] = both - time_ms(lambda: fwd(backend))
            except RuntimeError:            # the build offers no such kernel
                times[backend] = None
        return times

    for B, S, H, K, hd in FLASH_BWD_CASES:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dt)
            do = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dt)
            o, lse = fa.flash_attention(q, k, v, causal=True, with_lse=True)
            lse_err = (lse - ref.flash_attention_lse_ref(q, k, v)).abs()
            lse_want = ref.flash_attention_lse_ref(q, k, v).abs()
            check(bool((lse_err <= LSE_TOL[0] + LSE_TOL[1] * lse_want).all()),
                  f"flash_attention B={B},S={S},hd={hd} {dtype}: its "
                  f"log-sum-exp disagrees with the plain version "
                  f"(max abs err {lse_err.max().item():.3e})")
            got = fa.flash_attention_bwd(q, k, v, o, lse, do)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            times = launch_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))
            record("flash_attention_bwd", f"B={B},S={S},hd={hd}", dtype,
                   got, want,
                   lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                   lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do),
                   sdpa_times(q, k, v, do),
                   kbound(cost.flash_attention_bwd(q, k, lse), dtype),
                   tol=BWD_TOL[dtype],
                   lse_max_abs_err=lse_err.max().item(),
                   library_calls="SDPA forward + backward less forward",
                   launch_ms=times)
            print_launches("kernel", times)

    # the norms' backward at qwen2-1.5b's training rows, plain and
    # residual (dh in).  Bytes: x (h), dy (and dh) read once, w read once,
    # dx and dw written once.  Library: autograd of F.rms_norm (after the
    # eager add for the residual form), less its forward.
    rows, d = RMS_BWD_SHAPE
    for kind in ("rmsnorm_bwd", "add_rmsnorm_bwd"):
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn(d, generator=gen,
                                       device="cuda")).to(dt)
            dy = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
            dh = (torch.randn(rows, d, generator=gen, device="cuda").to(dt)
                  if kind == "add_rmsnorm_bwd" else None)
            got = rms.rmsnorm_bwd(x, w, dy, 1e-6, dh=dh)
            want = (ref.rmsnorm_bwd_ref(x, w, dy, 1e-6) if dh is None else
                    ref.add_rmsnorm_bwd_ref(x, w, dy, dh, 1e-6))
            torch.cuda.synchronize()
            xg, rg, wg = (t.detach().requires_grad_() for t in (x, x, w))
            if dh is None:
                def lib_fwd():
                    return F.rms_norm(xg, (d,), wg, 1e-6)

                def lib_both():
                    return torch.autograd.grad(lib_fwd(), (xg, wg), dy)
                plain = (lambda: ref.rmsnorm_bwd_ref(x, w, dy, 1e-6))
            else:
                def lib_fwd():
                    h = xg + rg
                    return h, F.rms_norm(h, (d,), wg, 1e-6)

                def lib_both():
                    return torch.autograd.grad(lib_fwd(), (xg, rg, wg),
                                               (dh, dy))
                plain = (lambda: ref.add_rmsnorm_bwd_ref(x, w, dy, dh, 1e-6))
            lib_ms = time_ms(lib_both) - time_ms(lib_fwd)
            times = launch_ms(lambda: rms.rmsnorm_bwd(x, w, dy, 1e-6, dh=dh))
            # autograd's backward alone: a graph built once, kept
            y = lib_fwd()
            lib_times = launch_ms(lambda: torch.autograd.grad(
                y, (xg, wg) if dh is None else (xg, rg, wg),
                dy if dh is None else (dh, dy), retain_graph=True))
            record(kind, f"rows={rows},d={d}", dtype, got, want,
                   lambda: rms.rmsnorm_bwd(x, w, dy, 1e-6, dh=dh), plain,
                   {"autograd": lib_ms},
                   kbound(cost.rmsnorm_bwd(x, w, dh is not None), dtype),
                   tol=BWD_TOL[dtype],
                   library_calls=("F.rms_norm" if dh is None else
                                  "x + r; F.rms_norm")
                   + ": forward + backward less forward",
                   launch_ms=times, library_launch_ms=lib_times)
            print_launches("kernel", times)
            print_launches("autograd", lib_times)

    # the gated norm's backward at mamba2-1.3b's training rows.  Bytes: x,
    # z, dy read once, w read once, dx, dz and dw written once.  Library:
    # autograd of x * F.silu(z) and F.rms_norm, less their forward.
    rows, d = GATED_BWD_SHAPE
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
        z = (2 * torch.randn(rows, d, generator=gen, device="cuda")).to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dt)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
        got = rms.gated_rmsnorm_bwd(x, z, w, dy, 1e-6)
        want = ref.gated_rmsnorm_bwd_ref(x, z, w, dy, 1e-6)
        torch.cuda.synchronize()
        xg, zg, wg = (t.detach().requires_grad_() for t in (x, z, w))

        def lib_fwd():
            return F.rms_norm(xg * F.silu(zg), (d,), wg, 1e-6)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_fwd(), (xg, zg, wg), dy)) - time_ms(lib_fwd)
        times = launch_ms(lambda: rms.gated_rmsnorm_bwd(x, z, w, dy, 1e-6))
        y = lib_fwd()
        lib_times = launch_ms(lambda: torch.autograd.grad(
            y, (xg, zg, wg), dy, retain_graph=True))
        record("gated_rmsnorm_bwd", f"rows={rows},d={d}", dtype, got, want,
               lambda: rms.gated_rmsnorm_bwd(x, z, w, dy, 1e-6),
               lambda: ref.gated_rmsnorm_bwd_ref(x, z, w, dy, 1e-6),
               {"autograd": lib_ms},
               kbound(cost.gated_rmsnorm_bwd(x, w), dtype),
               tol=BWD_TOL[dtype],
               library_calls="x * F.silu(z); F.rms_norm: forward + "
                             "backward less forward",
               launch_ms=times, library_launch_ms=lib_times)
        print_launches("kernel", times)
        print_launches("autograd", lib_times)

    # qwen2-1.5b's d_model; mamba2-1.3b's gated norm over d_inner
    for d, rows_list in ((1536, RMS_ROWS), (4096, RMS_ROWS_MAMBA)):
        for rows in rows_list:
            for dtype in ("bfloat16", "float32"):
                dt = getattr(torch, dtype)
                x = torch.randn(rows, d, generator=gen, device="cuda").to(dt)
                w = (1 + 0.1 * torch.randn(d, generator=gen,
                                           device="cuda")).to(dt)
                got = rms.rmsnorm(x, w, 1e-6)
                want = ref.rmsnorm_ref(x, w, 1e-6)
                torch.cuda.synchronize()
                shape = f"rows={rows}" + ("" if d == 1536 else f",d={d}")
                record("rmsnorm", shape, dtype, got, want,
                       lambda: rms.rmsnorm(x, w, 1e-6),
                       lambda: ref.rmsnorm_ref(x, w, 1e-6),
                       lambda: F.rms_norm(x, (d,), w, 1e-6),
                       kbound(cost.rmsnorm(x, w), dtype))

    # the fused norms.  Bytes: x, r or z and w read once, h (add) and out
    # written once; operations per element: 5 for add + norm (add, square
    # and sum, two products), 9 for the gated norm (silu's negation, exp,
    # add and division, the product, then the norm's 4).  Library: the
    # same function as PyTorch calls, the add or the gate separate from
    # F.rms_norm (no one call fuses them).
    for kind, dims in (("add_rmsnorm", ADD_NORM_DIMS),
                       ("gated_rmsnorm", (GATED_NORM_DIM,))):
        for d in dims:
            for rows in FUSED_ROWS:
                for dtype in ("bfloat16", "float32"):
                    dt = getattr(torch, dtype)
                    x = torch.randn(rows, d, generator=gen,
                                    device="cuda").to(dt)
                    o = torch.randn(rows, d, generator=gen,
                                    device="cuda").to(dt)
                    w = (1 + 0.1 * torch.randn(d, generator=gen,
                                               device="cuda")).to(dt)
                    if kind == "add_rmsnorm":
                        h, got = rms.add_rmsnorm(x, o, w, 1e-6)
                        want_h, want = ref.add_rmsnorm_ref(x, o, w, 1e-6)
                        torch.cuda.synchronize()
                        check(torch.equal(h, want_h),
                              f"add_rmsnorm rows={rows},d={d} {dtype}: h "
                              f"is not the eager x + r bit for bit")
                        fn = (lambda: rms.add_rmsnorm(x, o, w, 1e-6))
                        plain = (lambda: ref.add_rmsnorm_ref(x, o, w, 1e-6))
                        lib = (lambda: F.rms_norm(x + o, (d,), w, 1e-6))
                        b = kbound(cost.add_rmsnorm(x, w), dtype)
                    else:
                        got = rms.gated_rmsnorm(x, o, w, 1e-6)
                        want = ref.gated_rmsnorm_ref(x, o, w, 1e-6)
                        torch.cuda.synchronize()
                        fn = (lambda: rms.gated_rmsnorm(x, o, w, 1e-6))
                        plain = (lambda: ref.gated_rmsnorm_ref(x, o, w, 1e-6))
                        lib = (lambda: F.rms_norm(x * F.silu(o), (d,), w,
                                                  1e-6))
                        b = kbound(cost.gated_rmsnorm(x, w), dtype)
                    record(kind, f"rows={rows},d={d}", dtype, got, want, fn,
                           plain, lib, b, library_calls=(
                               "x + r; F.rms_norm" if kind == "add_rmsnorm"
                               else "x * F.silu(z); F.rms_norm"))

    # SSD at mamba2-1.3b's heads, f32 as on the model path, with B and C
    # shared by the heads through a head stride of 0 as ops.ssd_chunked
    # passes them.  No one PyTorch call computes this function, so its
    # library time is null.
    H, P, N = 64, 64, 128

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    for label, R, Q in SSD_CASES:
        x = randn(R, H, Q, P)
        dt = F.softplus(randn(R, H, Q))
        A = -torch.exp(randn(H))
        cs = torch.cumsum(dt * A[None, :, None], dim=-1)
        Bm = randn(R, 1, Q, N).expand(R, H, Q, N)
        Cm = randn(R, 1, Q, N).expand(R, H, Q, N)
        args = (x, dt, cs, Bm, Cm)
        got = ssd.ssd_chunk(*args)
        want = ref.ssd_chunk_ref(*args)
        # both against the same function in f64: the plain version's own
        # f32 error is the yardstick of the kernel's
        truth = ssd_f64(*args)
        f64 = {label: max((a.double() - t).abs().max().item()
                          for a, t in zip(pair, truth))
               for label, pair in (("kernel", got), ("plain", want))}
        torch.cuda.synchronize()
        # the kernel's products are 3xTF32 on the tensor cores; the f32
        # CUDA-core bound of the earlier kernel stays beside it
        record("ssd_chunk_kernel", label, "float32", got, want,
               lambda: ssd.ssd_chunk(*args),
               lambda: ref.ssd_chunk_ref(*args), None,
               kbound(cost.ssd_chunk(x, Bm), "tf32x3"), tol=SSD_TOL,
               bound_ms_f32=kbound(cost.ssd_chunk(x, Bm), "float32")[0],
               max_abs_err_vs_f64=f64)

    # the SSD backward on the same kind of inputs with random incoming
    # gradients.  Its products are 3xTF32 on the tensor cores, as the
    # forward's, so that rate bounds it; the f32 CUDA-core bound stands
    # beside it.  Every output within SSD_BWD_TOL of its max |value|.  No
    # one PyTorch call computes this function.
    for label, R, Q, shared in SSD_BWD_CASES:
        x = randn(R, H, Q, P)
        dt = F.softplus(randn(R, H, Q))
        A = -torch.exp(randn(H))
        cs = torch.cumsum(dt * A[None, :, None], dim=-1)
        G = 1 if shared else H
        Bm = randn(R, G, Q, N).expand(R, H, Q, N)
        Cm = randn(R, G, Q, N).expand(R, H, Q, N)
        args = (x, dt, cs, Bm, Cm, randn(R, H, Q, P), randn(R, H, N, P))
        got = ssd.ssd_chunk_bwd(*args)
        want = ref.ssd_chunk_bwd_ref(*args)
        torch.cuda.synchronize()
        times = launch_ms(lambda: ssd.ssd_chunk_bwd(*args))
        record("ssd_chunk_bwd", label, "float32", got, want,
               lambda: ssd.ssd_chunk_bwd(*args),
               lambda: ref.ssd_chunk_bwd_ref(*args), None,
               kbound(cost.ssd_chunk_bwd(x, Bm), "tf32x3"),
               tol=(SSD_BWD_TOL, 0.0), per_max=True, launch_ms=times,
               bound_ms_f32=kbound(cost.ssd_chunk_bwd(x, Bm),
                                   "float32")[0])
        print_launches("kernel", times)

    # stencil2d: bytes img once in, once out (and the K*K weights); 2 K^2
    # operations per output, f32 math whatever img's dtype.  Library:
    # cuDNN's correlation (TF32 off in main).
    for H, W, K, dtype in STENCIL_CASES:
        dt = getattr(torch, dtype)
        img = randn(H, W).to(dt)
        kern = randn(K, K).to(dt)
        got = stencil.stencil2d(img, kern)
        want = ref.stencil2d_ref(img, kern)
        torch.cuda.synchronize()
        record("stencil2d", f"{H}x{W},K={K}", dtype, got, want,
               lambda: stencil.stencil2d(img, kern),
               lambda: ref.stencil2d_ref(img, kern),
               lambda: F.conv2d(img[None, None], kern[None, None],
                                padding=K // 2),
               kbound(cost.stencil2d(img, kern), "float32"),
               tol=STENCIL_TOL[dtype])

    # bitonic_stage: bytes x once in, once out; one compare and two
    # selects per pair, counted as one operation per element at the f32
    # CUDA-core rate (int32 too).  No one PyTorch call computes a stage.
    for L, size, dist, offset, dtype in BITONIC_CASES:
        if dtype == "int32":
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (L,), generator=gen,
                              device="cuda", dtype=torch.int32)
        else:
            x = randn(L)
        got = bitonic.bitonic_stage(x, dist, size, offset)
        want = ref.bitonic_stage_ref(x, dist, size, offset)
        torch.cuda.synchronize()
        shape = f"L={L},size={size},dist={dist}" + (
            f",offset={offset}" if offset else "")
        record("bitonic_stage", shape, dtype, got, want,
               lambda: bitonic.bitonic_stage(x, dist, size, offset),
               lambda: ref.bitonic_stage_ref(x, dist, size, offset), None,
               kbound(cost.bitonic(x), "float32"), tol=(0.0, 0.0))

    # bitonic_block: bytes x once in, once out; one operation per element
    # and stage, as for a stage.  No one PyTorch call computes a run of
    # stages; BS's whole sort on the kernels is timed beside torch.sort
    # (the yardstick of the sort, recorded with the main case).
    from repro_torch.patterns import bs
    for L, size, offset, dtype in BITONIC_BLOCK_CASES:
        if dtype == "int32":
            x = torch.randint(-2 ** 31, 2 ** 31 - 1, (L,), generator=gen,
                              device="cuda", dtype=torch.int32)
        else:
            x = randn(L)
        got = bitonic.bitonic_block(x, size, bs.BLOCK, offset)
        want = ref.bitonic_block_ref(x, size, bs.BLOCK, offset)
        torch.cuda.synchronize()
        stages = len(ref.bitonic_block_stages(size, bs.BLOCK))
        extra = {}
        if (L, size, offset, dtype) == BITONIC_BLOCK_CASES[0]:
            ops.reset_launches()
            got_sort = bs.sort(x)
            counts = ops.launch_counts()
            sort_launches = {k: counts[k]
                             for k in ("bitonic_stage", "bitonic_block")}
            check(torch.equal(got_sort, torch.sort(x).values),
                  f"bs.sort of {L} on the kernels is not torch.sort")
            planned = [f"bitonic_{step[0]}" for step in bs._steps(L, bs.BLOCK)]
            plan = {k: planned.count(k) for k in sort_launches}
            check(sort_launches == plan,
                  f"bs.sort of {L} launched {sort_launches}, its plan {plan}")
            extra.update(sort_ms=time_ms(lambda: bs.sort(x)),
                         torch_sort_ms=time_ms(lambda: torch.sort(x)),
                         sort_launches=sort_launches)
            print(f"  BS sort of {L} f32 on the kernels "
                  f"(launches {sort_launches}) "
                  f"{extra['sort_ms']:.4f} ms, torch.sort "
                  f"{extra['torch_sort_ms']:.4f} ms")
        shape = f"L={L},size={size}" + (f",offset={offset}" if offset else "")
        record("bitonic_block", shape, dtype, got, want,
               lambda: bitonic.bitonic_block(x, size, bs.BLOCK, offset),
               lambda: ref.bitonic_block_ref(x, size, bs.BLOCK, offset), None,
               kbound(cost.bitonic(x, stages), "float32"),
               tol=(0.0, 0.0), **extra)
    return cases


def _greedy(api, cfg, params, prompt, n_new):
    """Batch-1 greedy decode through the api; returns tokens and each
    step's top-2 logit gap."""
    import torch
    cache = api.init_cache(cfg, 1, len(prompt) + n_new)
    logits, cache = api.prefill(params, cfg, cache, {"tokens": prompt[None]})
    toks, gaps = [], []
    for _ in range(n_new):
        top = torch.topk(logits[0], 2).values
        gaps.append((top[0] - top[1]).item())
        toks.append(int(torch.argmax(logits[0])))
        logits, cache = api.decode_step(
            params, cfg, cache, torch.tensor([toks[-1]], device="cuda"))
    return toks, gaps


# the kernels each served model's path must launch
PATH_KERNELS = {"qwen2-1.5b": ("flash_attention", "rmsnorm", "add_rmsnorm"),
                "mamba2-1.3b": ("ssd_chunk_kernel", "rmsnorm", "add_rmsnorm",
                                "gated_rmsnorm")}


def phase_serve(arch: str, phase: int):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api, get_config
    from repro_torch.serve import Engine, Request
    print(f"== phase {phase}: serve {arch} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()    # what earlier phases left
    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16" and (cfg.family == "ssm"
                                       or cfg.attn_impl == "flash"),
          f"unexpected config {cfg}")
    t0 = time.perf_counter()
    params = api.init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = api.param_count(params)
    check(n_params == cfg.param_count(), "param count")
    print(f"  init {n_params:,} params ({cfg.num_layers} layers, d="
          f"{cfg.d_model}, V={cfg.vocab_size}) in "
          f"{time.perf_counter() - t0:.1f} s")

    # the backward check draws from its own generator, so the probe and
    # the traffic below stay the ones earlier runs measured
    grad_row = backward_check(api, cfg, params, np.random.default_rng(1))
    rng = np.random.default_rng(0)
    probe = torch.as_tensor(rng.integers(0, cfg.vocab_size, PROBE_LEN),
                            device="cuda")[None]
    outs = {}
    for label, c in (("kernels", cfg), ("plain", cfg.replace(use_kernels=False))):
        cache = api.init_cache(c, 1, PROBE_LEN)
        outs[label], _ = api.prefill(params, c, cache, {"tokens": probe})
    diff = (outs["kernels"] - outs["plain"]).abs().max().item()
    top = [int(outs[k][0, :cfg.vocab_size].argmax()) for k in outs]
    print(f"  prefill logits (S={PROBE_LEN}): kernels vs plain max|diff| "
          f"{diff:.4e} (atol {PROBE_ATOL}), top-1 {top[0]} vs {top[1]}")
    check(bool(torch.isfinite(outs["kernels"][0, :cfg.vocab_size]).all()),
          "non-finite prefill logits")
    if arch in F32_ANCHORED_PROBE:
        probe_row = probe_against_f32(api, cfg, params, probe, outs)
    else:
        check(diff <= PROBE_ATOL and top[0] == top[1],
              "kernel-path prefill disagrees with the plain path")
        probe_row = {"max_abs_diff": diff}

    eng = Engine(cfg, params, slots=4, max_seq=2048, device="cuda")
    lens = rng.integers(64, 1001, 16)
    for uid, n in enumerate(lens):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab_size, n),
                           max_new_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    admit_ms, decode_ms, done = [], [], []
    with lse_requests() as lse_flags:
        t0 = time.perf_counter()
        while eng.queue or eng.active:
            prefills, s0 = eng.prefills, time.perf_counter()
            done += eng.step()
            ms = (time.perf_counter() - s0) * 1e3
            (admit_ms if eng.prefills != prefills else decode_ms).append(ms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    toks = sum(len(r.output) for r in done)
    steps = {"admit_steps": len(admit_ms), "admit_ms_total": sum(admit_ms),
             "decode_only_steps": len(decode_ms),
             "decode_only_ms_total": sum(decode_ms),
             "decode_step_ms_median": statistics.median(decode_ms),
             "decode_step_ms_max": max(decode_ms)}
    prefills = eng.prefills
    print(f"  served {len(done)} requests, {toks} tokens in {wall:.3f} s "
          f"({toks / wall:.1f} tok/s), prompt tokens {int(lens.sum())}, "
          f"stats {eng.stats()}, peak {peak:.2f} GiB above the {base / 2**30:.2f} "
          f"GiB earlier phases left, launches {launches}")
    print(f"  steps: {steps}")
    check(len(done) == 16 and all(len(r.output) == 32 for r in done),
          "not every request got its 32 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.output),
          "token outside the vocabulary")
    for name in PATH_KERNELS[arch]:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the {arch} path")
    for name in BACKWARD_KERNELS:
        check(launches[name] == 0, f"serving {arch} launched {name}")
    check(not any(lse_flags), f"serving {arch} stored a log-sum-exp "
                              f"({sum(lse_flags)} of {len(lse_flags)} flash "
                              f"launches)")
    if cfg.family == "ssm":
        check(launches["ssd_chunk_kernel"] == cfg.num_layers * prefills,
              f"ssd_chunk_kernel launched {launches['ssd_chunk_kernel']} "
              f"times, not once per layer of {prefills} prefills")
    serve = {"arch": arch, "probe": probe_row, "backward": grad_row,
             "requests": len(done),
             "new_tokens": toks,
             "wall_s": wall, "tokens_per_s": toks / wall, "peak_gib": peak,
             "prompt_tokens": int(lens.sum()), "prefills": prefills,
             "launches": launches, **steps,
             "decode_profile": profile_decode(eng, rng)}
    busy = serve["decode_profile"]["device_busy_ms"]
    serve["idle_share"] = 1 - busy / steps["decode_step_ms_median"]
    print(f"  device idle share of a decode step: {serve['idle_share']:.3f} "
          f"({busy:.3f} ms busy of the {steps['decode_step_ms_median']:.1f} "
          f"ms median step)")
    check(busy > 0, "the profiler saw no device time in decode steps")
    del params, eng
    torch.cuda.empty_cache()
    return serve


# the backward kernels, which serving must never launch
BACKWARD_KERNELS = ("flash_attention_bwd", "rmsnorm_bwd", "add_rmsnorm_bwd",
                    "gated_rmsnorm_bwd", "ssd_chunk_bwd")


def step_launches(cfg) -> dict:
    """The kernel launches of one training step (forward and backward) of
    a model of ``cfg``: a layer's mixer (flash attention, or the SSD chunk
    and the gated norm), its pre-norms with the residual add fused in (the
    first layer's is plain), and the final norm."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        fwd = {"ssd_chunk_kernel": L, "gated_rmsnorm": L, "rmsnorm": 1,
               "add_rmsnorm": L}
    else:
        fwd = {"flash_attention": L, "rmsnorm": 1, "add_rmsnorm": 2 * L}
    bwd = {k.replace("_kernel", "") + "_bwd": v for k, v in fwd.items()}
    return {**fwd, **bwd}


def _float_leaves(params):
    leaves = []
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif t.is_floating_point():
            leaves.append(t)
    return leaves


@contextlib.contextmanager
def planted_fault(module: str, launcher: str, rounding: str):
    """Inside the block, ``repro_torch.kernels.<module>.<launcher>``'s
    outputs come back rounded to bf16, or to fp8 e4m3 scaled by each
    output's max |value|: a lower-precision fault for the bf16 gradient
    gate's control."""
    import importlib
    import torch
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    real = getattr(mod, launcher)

    def bf16(t):
        return t.to(torch.bfloat16).to(t.dtype)

    def fp8(t):
        scale = t.abs().amax().float().clamp(min=1e-30) / 448
        return ((t.float() / scale).to(torch.float8_e4m3fn).float()
                * scale).to(t.dtype)
    rnd = {"bf16": bf16, "fp8": fp8}[rounding]

    def faulty(*args, **kwargs):
        return tuple(rnd(t) for t in real(*args, **kwargs))
    setattr(mod, launcher, faulty)
    try:
        yield
    finally:
        setattr(mod, launcher, real)


@contextlib.contextmanager
def lse_requests():
    """Yields a list that records, for every forward flash launch made
    inside the block, whether it asked for the log-sum-exp."""
    from repro_torch.kernels import flash_attention as fa
    real, flags = fa.flash_attention, []

    def spy(*args, **kwargs):
        flags.append(bool(kwargs.get("with_lse", False)))
        return real(*args, **kwargs)
    fa.flash_attention = spy
    try:
        yield flags
    finally:
        fa.flash_attention = real


def backward_check(api, cfg, params, rng):
    """With the params requiring grad, ``api.loss(...).backward()`` on
    the kernel path runs the backward kernels (``step_launches``: qwen's
    flash once a layer and residual norm twice, mamba's SSD, gated norm
    and residual norm once a layer; the plain norm once) and gives every
    param a finite gradient.  The distance of each param's gradient to
    the bf16 plain path's is printed; phases 8 and 10 hold gradients to a
    reference."""
    import torch
    from repro_torch.kernels import ops
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 65)),
                           device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    leaves = _float_leaves(params)
    grads = {}
    try:
        for t in leaves:
            t.requires_grad_(True)
        for label, c in (("kernels", cfg),
                         ("plain", cfg.replace(use_kernels=False))):
            ops.reset_launches()
            loss = api.loss(params, c, batch)
            loss.backward()
            torch.cuda.synchronize()
            grads[label] = [t.grad for t in leaves]
            if label == "kernels":
                launches = ops.launch_counts()
            for t in leaves:
                t.grad = None
    finally:
        for t in leaves:
            t.requires_grad_(False)
            t.grad = None
    want = {k: v for k, v in step_launches(cfg).items()
            if k.endswith("_bwd")}
    got = {k: launches[k] for k in want}
    check(got == want, f"the backward launched {got}, expected {want}")
    check(all(g is not None and bool(torch.isfinite(g).all())
              for g in grads["kernels"]),
          "a param got no gradient, or a non-finite one, on the kernel path")
    rel = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max().clamp(min=1e-30)).item()
              for a, b in zip(grads["kernels"], grads["plain"]))
    print(f"  loss().backward() on the kernel path: launches {got}, every "
          f"gradient finite; largest per-param distance to the bf16 plain "
          f"path {rel:.4e} of that param's max |g|")
    return {"launches": got, "max_rel_to_plain_bf16": rel}


def probe_against_f32(api, cfg, params, probe, outs):
    """The bf16 probe held to the same weights in f32 (see
    F32_ANCHORED_PROBE); ``outs`` has the bf16 "kernels" and "plain"
    logits.  Returns the distances."""
    import torch
    cast = (lambda t: {k: cast(v) for k, v in t.items()}
            if isinstance(t, dict) else t.float())
    p32, c32 = cast(params), cfg.replace(dtype="float32")
    for label, c in (("f32 kernels", c32),
                     ("f32 plain", c32.replace(use_kernels=False))):
        cache = api.init_cache(c, 1, PROBE_LEN)
        outs[label], _ = api.prefill(p32, c, cache, {"tokens": probe})
    del p32
    V = cfg.vocab_size
    truth = outs["f32 plain"][0, :V]
    dist = {k: (outs[k][0, :V] - truth).abs().max().item()
            for k in ("kernels", "plain", "f32 kernels")}
    top = {k: int(v[0, :V].argmax()) for k, v in outs.items()}
    print(f"  against the f32 plain path (max|logit| "
          f"{truth.abs().max().item():.3f}): bf16 kernels {dist['kernels']:.4e}"
          f", bf16 plain {dist['plain']:.4e} (kernels may exceed plain by "
          f"{PROBE_ATOL}), f32 kernels {dist['f32 kernels']:.4e} (atol "
          f"{F32_PROBE_ATOL}); top-1 {top}")
    check(len(set(top.values())) == 1, "the probe's top-1 token differs")
    check(dist["f32 kernels"] <= F32_PROBE_ATOL,
          "f32 kernel-path prefill disagrees with the f32 plain path")
    check(dist["kernels"] <= dist["plain"] + PROBE_ATOL,
          "bf16 kernel-path prefill is farther from f32 than the plain path")
    return {"max_abs_diff": (outs["kernels"] - outs["plain"]).abs().max()
            .item(), "against_f32": dist}


def profile_decode(eng, rng, steps: int = 5):
    """Device busy ms of decode-only engine steps (4 active slots), from
    torch.profiler, after the counted run.  The profiler slows the host,
    so the idle share is taken against the unprofiled step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request
    for uid in range(eng.slots):
        eng.submit(Request(uid=1000 + uid, max_new_tokens=16,
                           prompt=rng.integers(0, eng.cfg.vocab_size, 128)))
    eng.step()                                  # admits all slots
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"step_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
           "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
           "top_kernels_ms_per_step": {
               e.key[:60]: e.self_device_time_total / 1e3 / steps
               for e in top}}
    print(f"  decode profile ({steps} steps, 4 slots): {out}")
    while eng.active or eng.queue:
        eng.step()
    return out


def phase_f32(arch: str, phase: int):
    import numpy as np
    import torch
    from repro_torch.models import api, get_config
    print(f"== phase {phase}: {arch} at full width in f32, kernel path vs "
          f"plain path", flush=True)
    cfg = get_config(arch).replace(dtype="float32")
    params = api.init(0, cfg, device="cuda")
    rng = np.random.default_rng(1)
    for i, n in enumerate((211, 640)):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                 device="cuda")
        got, gaps = _greedy(api, cfg, params, prompt, 16)
        want, _ = _greedy(api, cfg.replace(use_kernels=False), params,
                          prompt, 16)
        parted = next((j for j, (a, b) in enumerate(zip(got, want))
                       if a != b), None)
        print(f"  request {i} (prompt {n}): kernel path {got[:8]}..., "
              f"identical: {parted is None}, smallest top-2 gap "
              f"{min(gaps):.3e}")
        if parted is not None:
            raise RuntimeError(f"f32 paths part at step {parted}: top-2 "
                               f"gap there {gaps[parted]:.3e}")
    del params
    torch.cuda.empty_cache()


def phase_mgmark():
    """Phase 7.  Returns (per-run rows, launches of the checked runs by
    kernel, the simulated numbers)."""
    import math
    import torch
    from repro_torch.core import ChipSpec, SystemSpec, simulate
    from repro_torch.core.hlo import kernel_ops
    from repro_torch.kernels import ops
    from repro_torch.launch import mgmark
    from repro_torch.patterns import Mesh
    from repro_torch.patterns.base import finite
    print(f"== phase 7: MGMark, U-mode and D-mode on a {MGMARK_SHARDS}-shard "
          f"mesh on the card", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = Mesh(["cuda"] * MGMARK_SHARDS)
    ops.reset_launches()
    t0 = time.perf_counter()
    reports = mgmark.run_suite(mesh)
    wall = time.perf_counter() - t0
    total = ops.launch_counts()
    # each report's launches are its checked run's; the warm call and the
    # timed repeats launch the same kernels again; the traces launch none
    path = {k: sum(r.launches[k] for r in reports) for k in total}
    specs = {"v5e": SystemSpec(pod_shape=(1, MGMARK_SHARDS)),
             "h100-sxm": SystemSpec(chip=ChipSpec(**H100_CHIP),
                                    pod_shape=(1, MGMARK_SHARDS))}
    rows = []
    for rep in reports:
        print("  " + rep.row(), flush=True)
        check(rep.correct, f"MGMark {rep.name} {rep.mode}: output disagrees "
                           f"with the oracle (max abs err {rep.max_err})")
        check(rep.device_ms is not None and rep.device.startswith("cuda"),
              f"MGMark {rep.name} {rep.mode} did not run on the card")
        want = MGMARK_LAUNCHES.get((rep.name, rep.mode), {})
        got = {k: v for k, v in rep.launches.items() if v}
        check(got == want, f"MGMark {rep.name} {rep.mode} launched {got}, "
                           f"expected {want}")
        # the traced kernel ops: one device's program, so D-mode's are
        # summed over every shard's trace
        traced = kernel_ops(
            [op for ops_ in rep.cost.shards.values() for op in ops_]
            if rep.mode == "dmode" else rep.cost.trace)
        check(traced == got, f"MGMark {rep.name} {rep.mode}: traced kernel "
                             f"ops {traced}, launched {got}")
        check(finite(rep), f"MGMark {rep.name} {rep.mode}: simulated fields "
                           f"{rep.sim_time_s, rep.compute_util, rep.flops}")
        traced_bytes = rep.cost.collective_bytes
        if rep.mode == "dmode":
            check(rep.collective_bytes == traced_bytes
                  == MGMARK_BYTES[rep.name],
                  f"MGMark {rep.name} D-mode moved {rep.collective_bytes} B "
                  f"per device, traced {traced_bytes}, expected "
                  f"{MGMARK_BYTES[rep.name]}")
        else:
            check(rep.collective_bytes == traced_bytes
                  == MGMARK_UMODE_BYTES[rep.name],
                  f"MGMark {rep.name} U-mode traced {traced_bytes} B per "
                  f"device, expected {MGMARK_UMODE_BYTES[rep.name]}")
        sims = {label: simulate(cost=rep.cost, spec=spec,
                                device_limit=8).time_s * 1e3
                for label, spec in specs.items()}
        check(sims["v5e"] == rep.sim_time_s * 1e3 and all(
            math.isfinite(v) for v in sims.values()),
            f"MGMark {rep.name} {rep.mode}: simulated {sims}")
        rows.append({**{k: getattr(rep, k) for k in (
            "name", "mode", "pattern", "correct", "max_err",
            "collective_bytes", "bytes_by_kind", "device", "launches",
            "device_ms", "compute_util", "flops", "hbm_bytes")},
            "sim_ms": sims, "trace_ops": len(rep.cost.trace),
            "traced_kernel_ops": traced,
            "unattributed_ops": len(rep.cost.unattributed)
            if rep.mode == "dmode" else None})
        print(f"    SIMULATED (not measured) on {MGMARK_SHARDS} chips: "
              f"{sims['v5e']:.6f} ms on the reference's default SystemSpec "
              f"(a TPU v5e ChipSpec: configured), {sims['h100-sxm']:.6f} ms "
              f"with the H100 datasheet ChipSpec; measured "
              f"{rep.device_ms:.4f} ms on 4 shards of one card")
    calls = 2 + mgmark.REPEATS
    check(all(total[k] == path[k] * calls for k in total),
          f"launch counters {total} are not {calls} x the checked runs' "
          f"{path}")
    ratios = {label: mgmark.validate(reports, spec)
              for label, spec in specs.items()}
    for label, vs in ratios.items():
        print(f"  D-mode SIMULATED / analytic bound on {label}: " + "; ".join(
            f"{v['name']} {v['ratio']:.3f}" for v in vs))
        check(all(math.isfinite(v["ratio"]) and v["ratio"] > 0 for v in vs),
              f"sim/bound ratios on {label}: {vs}")
    lessons = mgmark.lessons(reports)
    for line in lessons:
        print("  lesson " + line)
    print(f"  {len(reports)} runs in {wall:.1f} s (inputs, oracles, timing "
          f"and traces included); kernel launches of the checked runs {path}")
    return rows, path, {"ratios": ratios, "lessons": lessons}


def _grads(api, optim, params, cfg, batch):
    """(loss, gradients of every param in optim.leaves order)."""
    import torch
    flat = optim.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        loss = api.loss(params, cfg, batch)
        return loss.item(), torch.autograd.grad(loss, flat)
    finally:
        for t in flat:
            t.requires_grad_(False)


def _rel(a, b):
    """max |a - b| relative to max |b|, in f32."""
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30)
            ).item()


def _rel_l2(a, b):
    """||a - b|| relative to ||b||, in f32."""
    b = b.float()
    return ((a.float() - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_train(arch: str, phase: int):
    """Phase 8 (and 10 (a)-(c) for mamba).  Returns (the phase's numbers,
    launches of the 20-step run by kernel)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api, get_config
    from repro_torch.sharding import umode
    from repro_torch.train import optim
    from repro_torch.train.data import DataConfig, SyntheticLM
    print(f"== phase {phase}: train {arch} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    L = cfg.num_layers
    per_step = step_launches(cfg)
    def grad_batch(seed):
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_GRAD_SEQ,
                                      global_batch=TRAIN_GRAD_BATCH,
                                      seed=seed))
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in data.global_batch(0).items()}
    batch = grad_batch(TRAIN_GRAD_SEEDS[0])
    out = {"arch": arch, "grad_batch": [TRAIN_GRAD_BATCH, TRAIN_GRAD_SEQ]}

    # (a) f32 gradients, kernel path vs plain path, full depth
    c32 = cfg.replace(dtype="float32")
    p32 = api.init(0, c32, device="cuda")
    ops.reset_launches()
    loss_k, g_k = _grads(api, optim, p32, c32, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    check(launches == per_step, f"f32 kernel-path gradient launched "
                                f"{launches}, expected {per_step}")
    loss_p, g_p = _grads(api, optim, p32, c32.replace(use_kernels=False),
                         batch)
    rel32 = [_rel(a, b) for a, b in zip(g_k, g_p)]
    del g_k
    names = [".".join(p) for p in _paths(p32)]
    worst = int(np.argmax(rel32))
    print(f"  (a) f32 gradients (batch {TRAIN_GRAD_BATCH} x {TRAIN_GRAD_SEQ}, "
          f"{L} layers): loss kernels {loss_k:.6f} plain {loss_p:.6f}; "
          f"largest per-param distance {rel32[worst]:.3e} ({names[worst]}) "
          f"of max |g| (tol {TRAIN_F32_TOL})")
    check(all(np.isfinite(rel32)) and max(rel32) <= TRAIN_F32_TOL,
          f"f32 kernel-path gradient of {names[worst]} is {rel32[worst]:.3e} "
          f"of its max |g| from the plain path")
    out["f32"] = {"loss_kernels": loss_k, "loss_plain": loss_p,
                  "max_rel": rel32[worst], "worst": names[worst],
                  "rel_by_param": dict(zip(names, rel32))}

    # (b) bf16 gradients held to the f32 plain ones on each seed's batch,
    # each param in the dtype the bf16 config gives it (mamba keeps its
    # SSM leaves in f32); then the planted faults, which must fail
    dtypes = [t.dtype for t in optim.leaves(api.init(0, cfg, device="meta"))]
    pbf = optim.unflatten(p32, [t.to(d) for t, d in
                                zip(optim.leaves(p32), dtypes)])
    margins = TRAIN_BF16_MARGINS[cfg.family]
    controls = TRAIN_BF16_CONTROLS.get(cfg.family, ())
    bf16 = {"margins": {"max_abs": margins[0], "l2": margins[1]},
            "seeds": {}, "controls": {c[0]: {} for c in controls}}

    def distances(params, c, want):
        """(loss, per param (max-abs, L2) distance to ``want``)."""
        loss, g = _grads(api, optim, params, c, batch)
        return loss, [(_rel(a, b), _rel_l2(a, b)) for a, b in zip(g, want)]

    def excess(dist, plain):
        """per metric: (largest excess over the plain path, its param)."""
        res = []
        for m in range(2):
            e = [a[m] - b[m] for a, b in zip(dist, plain)]
            i = int(np.argmax(e))
            res.append((e[i], names[i]))
        return res
    for seed in TRAIN_GRAD_SEEDS:
        if seed != TRAIN_GRAD_SEEDS[0]:     # the first's are (a)'s
            batch = grad_batch(seed)
            _, g_p = _grads(api, optim, p32,
                            c32.replace(use_kernels=False), batch)
        loss_bk, dist_k = distances(pbf, cfg, g_p)
        loss_bp, dist_p = distances(pbf, cfg.replace(use_kernels=False),
                                    g_p)
        (ex_abs, w_abs), (ex_l2, w_l2) = excess(dist_k, dist_p)
        print(f"  (b) bf16 gradients against the f32 plain path, batch "
              f"seed {seed}: loss kernels {loss_bk:.6f} plain "
              f"{loss_bp:.6f}; largest max-abs distance kernel path "
              f"{max(d[0] for d in dist_k):.3e}, plain path "
              f"{max(d[0] for d in dist_p):.3e}, largest excess "
              f"{ex_abs:.3e} ({w_abs}; margin {margins[0]}); largest L2 "
              f"distance kernel path {max(d[1] for d in dist_k):.3e}, "
              f"plain path {max(d[1] for d in dist_p):.3e}, largest excess "
              f"{ex_l2:.3e} ({w_l2}; margin {margins[1]})")
        check(all(np.isfinite(d).all() for d in dist_k)
              and ex_abs <= margins[0] and ex_l2 <= margins[1],
              f"bf16 kernel-path gradients on batch seed {seed} are farther "
              f"from the f32 plain ones than the bf16 plain path's by "
              f"{ex_abs:.3e} ({w_abs}) in max-abs, {ex_l2:.3e} ({w_l2}) in "
              f"L2")
        bf16["seeds"][seed] = {
            "loss_kernels": loss_bk, "loss_plain": loss_bp,
            "max_excess": ex_abs, "max_excess_worst": w_abs,
            "max_excess_l2": ex_l2, "max_excess_l2_worst": w_l2,
            "max_dist_kernels": max(d[0] for d in dist_k),
            "max_dist_plain": max(d[0] for d in dist_p),
            "max_l2_kernels": max(d[1] for d in dist_k),
            "max_l2_plain": max(d[1] for d in dist_p),
            "dist_by_param": {n: [*k, *p] for n, k, p in
                              zip(names, dist_k, dist_p)}}
        for label, module, launcher, rounding in controls:
            with planted_fault(module, launcher, rounding):
                _, dist_c = distances(pbf, cfg, g_p)
            (c_abs, cw_abs), (c_l2, cw_l2) = excess(dist_c, dist_p)
            caught = c_abs > margins[0] or c_l2 > margins[1]
            print(f"      control, {label}: excess max-abs {c_abs:.3e} "
                  f"({cw_abs}), L2 {c_l2:.3e} ({cw_l2}); caught: {caught}")
            check(caught, f"the bf16 gate let a planted fault through: "
                          f"{label}")
            bf16["controls"][label][seed] = {
                "max_excess": c_abs, "max_excess_worst": cw_abs,
                "max_excess_l2": c_l2, "max_excess_l2_worst": cw_l2}
        del g_p
    out["bf16"] = bf16
    del p32, pbf
    gc.collect()
    torch.cuda.empty_cache()

    # (c) AdamW steps through the launcher's code
    opt_cfg = optim.OptConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                              warmup_steps=max(1, TRAIN_STEPS // 10))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    state, records = launch_train.run(cfg, data_cfg, opt_cfg, TRAIN_STEPS,
                                      device="cuda",
                                      log=lambda line: print("  " + line))
    run_launches = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    want = {k: TRAIN_STEPS * per_step.get(k, 0) for k in run_launches}
    check(run_launches == want, f"{TRAIN_STEPS} steps launched "
                                f"{run_launches}, expected {want}")
    losses = [r["loss"] for r in records]
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first, f"the loss did not fall: first 5 steps {first:.4f}, "
                        f"last 5 {last:.4f}")
    step_ms = statistics.median(r["step_ms"] for r in records[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # one more step with the launch counters read around it, then two
    # under the profiler (device busy; the idle share is taken against
    # the unprofiled median step)
    step_fn = umode.make_train_step(cfg, opt_cfg)
    batches = [SyntheticLM(data_cfg).global_batch(TRAIN_STEPS + i)
               for i in range(3)]
    ops.reset_launches()
    state, m = step_fn(state, batches[0])
    m["loss"].item()
    one = {k: v for k, v in ops.launch_counts().items() if v}
    check(one == per_step, f"one step launched {one}, expected {per_step}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, m = step_fn(state, b)
            m["loss"].item()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 2
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    check(busy_ms > 0, "the profiler saw no device time in training steps")
    groups = {}
    for e in kernels:
        g = next((g for g, pats in TRAIN_KERNEL_GROUPS
                  if any(p in e.key for p in pats)), "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / 2

    # the step's two halves, CUDA events around each (host gaps included):
    # loss and gradients, then the AdamW update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    _, g = _grads(api, optim, state["params"], cfg,
                  {k: torch.as_tensor(v, device="cuda")
                   for k, v in batches[0].items()})
    ev[1].record()
    optim.adamw_update(state, optim.unflatten(state["params"], g), opt_cfg)
    ev[2].record()
    ev[2].synchronize()
    halves = {"loss_and_grad_ms": ev[0].elapsed_time(ev[1]),
              "adamw_update_ms": ev[1].elapsed_time(ev[2])}
    del g
    out["steps"] = {
        "steps": TRAIN_STEPS, "batch": [TRAIN_BATCH, TRAIN_SEQ],
        "lr": TRAIN_LR, "losses": losses, "loss_first5": first,
        "loss_last5": last, "step_ms": [r["step_ms"] for r in records],
        "step_ms_median": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "peak_gib": peak, "base_gib": base / 2 ** 30,
        "launches_per_step": one, "device_busy_ms": busy_ms,
        "step_ms_profiled": prof_ms, "idle_share": 1 - busy_ms / step_ms,
        "kernel_launches_per_step": sum(e.count for e in kernels) / 2,
        "device_ms_per_step_by_group": groups, **halves}
    print(f"  (c) {TRAIN_STEPS} AdamW steps, batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of "
          f"first 5 {first:.4f}, last 5 {last:.4f}); median step "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tok/s; peak "
          f"{peak:.2f} GiB above the {base / 2 ** 30:.2f} GiB left before; "
          f"launches per step {one}")
    print(f"  device busy {busy_ms:.2f} ms of a step ({prof_ms:.1f} ms "
          f"profiled), idle share {out['steps']['idle_share']:.3f}; device "
          f"ms per step by kernel group {groups}; one more step: loss and "
          f"gradients {halves['loss_and_grad_ms']:.1f} ms, AdamW update "
          f"{halves['adamw_update_ms']:.1f} ms")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out, run_launches


def _checksums(state):
    """{leaf path: int64 sum of the leaf's bits (viewed as int16 or int32),
    taken on the card}; ints as themselves."""
    import torch
    from repro_torch.train.checkpoint import _flatten
    flat = _flatten(state)
    keys = [k for k, t in flat.items() if isinstance(t, torch.Tensor)]
    bits = {2: torch.int16, 4: torch.int32}
    sums = torch.stack([flat[k].view(bits[flat[k].element_size()])
                        .sum(dtype=torch.int64) for k in keys]).tolist()
    return {**dict(zip(keys, sums)),
            **{k: t for k, t in flat.items() if k not in keys}}


@contextlib.contextmanager
def checkpoint_spy(log):
    """Wraps CheckpointManager's save, write and restore: per-leaf
    checksums of each saved state (before the save) and each restored
    one, and the seconds of each part, appended to ``log``."""
    import os
    from repro_torch.train.checkpoint import CheckpointManager as M
    real = {k: getattr(M, k) for k in ("save", "_write", "restore")}

    def save(self, step, state, extra=None):
        log["saved"][step] = _checksums(state)
        t0 = time.perf_counter()
        self.wait()                   # the previous write, timed apart
        t1 = time.perf_counter()
        out = real["save"](self, step, state, extra)
        log["saves"].append({"step": step, "wait_s": t1 - t0,
                             "snapshot_s": time.perf_counter() - t1,
                             "at": t0})
        return out

    def write(self, step, snapshot, extra):
        t0 = time.perf_counter()
        path = real["_write"](self, step, snapshot, extra)
        nbytes = sum(e.stat().st_size for e in os.scandir(path))
        log["writes"].append({"step": step, "write_s":
                              time.perf_counter() - t0, "bytes": nbytes,
                              "at": t0, "end": time.perf_counter()})
        return path

    def restore(self, step=None, device="cuda"):
        t0 = time.perf_counter()
        tree, manifest = real["restore"](self, step, device)
        if tree is not None:
            log["restored"][manifest["step"]] = _checksums(tree)
            log["restores"].append({"step": manifest["step"], "restore_s":
                                    time.perf_counter() - t0})
        return tree, manifest
    M.save, M._write, M.restore = save, write, restore
    try:
        yield log
    finally:
        for k, f in real.items():
            setattr(M, k, f)


def loop_check(cfg, steps: int, ckpt_every: int, fault_step: int,
               remesh_step, train_step_ms: float):
    """``repro_torch.train.loop.run`` of ``cfg`` at the training shape for
    ``steps`` steps, a checkpoint every ``ckpt_every`` (async, the last
    kept), a failure injected before ``fault_step`` (in [ckpt_every + 2,
    2 ckpt_every): the restore is from step ``ckpt_every`` and two
    replayed steps ran before the fault) and, unless None, a re-mesh onto
    a fresh 1x1 mesh before ``remesh_step``.  Checks one restart, the
    restored state equal to the saved one (per-leaf checksums on the
    card), both replayed losses equal to the first ones bit for bit, and
    the kernels launched as the steps run say.  Returns (its numbers, the
    launches by kernel)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import umode
    from repro_torch.train import loop, optim
    from repro_torch.train.data import DataConfig
    check(ckpt_every + 2 <= fault_step < 2 * ckpt_every, "fault step")
    tmp = tempfile.gettempdir()
    free0 = shutil.disk_usage(tmp).free
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    log = {"saved": {}, "restored": {}, "saves": [], "writes": [],
           "restores": []}
    starts = []                       # host clock at each step's call
    real_make = umode.make_train_step

    def make_step(*args, **kwargs):
        step = real_make(*args, **kwargs)

        def timed(state, batch):
            starts.append(time.perf_counter())
            return step(state, batch)
        return timed
    loop.umode.make_train_step = make_step
    remesh = {} if remesh_step is None else {
        remesh_step: make_mesh((1, 1), ("data", "model"))}
    ops.reset_launches()
    try:
        with checkpoint_spy(log):
            rep = loop.run(
                cfg, make_mesh((1, 1), ("data", "model")),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH),
                opt_cfg=optim.OptConfig(lr=TRAIN_LR, total_steps=steps,
                                        warmup_steps=1),
                loop_cfg=loop.LoopConfig(
                    total_steps=steps, ckpt_every=ckpt_every,
                    keep=LOOP_KEEP, ckpt_dir=ckpt_dir, async_ckpt=True,
                    log_every=1),
                fault_schedule={fault_step:
                                RuntimeError("injected node failure")},
                remesh_schedule=remesh)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        loop.umode.make_train_step = real_make
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"  {rep.steps_run} steps run, restarts {rep.restarts}, re-mesh "
          f"events {rep.remesh_events}, final step {rep.final_step}, "
          f"stragglers {rep.straggler_steps}; losses {rep.losses}")
    check(rep.restarts == 1 and rep.remesh_events == len(remesh)
          and rep.final_step == steps,
          f"loop: restarts {rep.restarts}, re-mesh {rep.remesh_events}, "
          f"final step {rep.final_step}")
    check(all(np.isfinite(rep.losses)), f"non-finite loss: {rep.losses}")
    # steps 0..fault-1, then the restore from ckpt_every and the rest
    check(len(rep.losses) == fault_step + steps - ckpt_every,
          f"{len(rep.losses)} losses")
    want = {k: rep.steps_run * v for k, v in step_launches(cfg).items()}
    got = {k: v for k, v in launches.items() if v}
    check(got == want, f"the loop launched {got}, expected {want}")
    saved, restored = log["saved"], log["restored"]
    check(list(restored) == [ckpt_every],
          f"restored steps {list(restored)}, expected [{ckpt_every}]")
    same_state = restored[ckpt_every] == saved[ckpt_every]
    check(same_state, f"the state restored at step {ckpt_every} is not the "
                      f"one saved (per-leaf checksums differ)")
    replay = rep.losses[fault_step] == rep.losses[ckpt_every]
    check(replay, f"step {ckpt_every} replayed gives "
                  f"{rep.losses[fault_step]!r}, before the fault "
                  f"{rep.losses[ckpt_every]!r}")
    replay_next = rep.losses[fault_step + 1] == rep.losses[ckpt_every + 1]
    check(replay_next, f"step {ckpt_every + 1} replayed gives "
                       f"{rep.losses[fault_step + 1]!r}, before the fault "
                       f"{rep.losses[ckpt_every + 1]!r}")
    busy = [(w["at"], w["end"]) for w in log["writes"]] + \
        [(v["at"], v["at"] + v["wait_s"] + v["snapshot_s"])
         for v in log["saves"]]
    quiet = [dt * 1e3 for i, (t0, dt) in enumerate(zip(starts, rep.step_s))
             if i > 0 and not any(a < t0 + dt and t0 < b for a, b in busy)]
    out = {
        "arch": cfg.name, "steps_run": rep.steps_run,
        "final_step": rep.final_step, "restarts": rep.restarts,
        "remesh_events": rep.remesh_events,
        "straggler_steps": rep.straggler_steps, "losses": rep.losses,
        "step_ms": [t * 1e3 for t in rep.step_s],
        "step_ms_median_all": statistics.median(rep.step_s[1:]) * 1e3,
        "step_ms_median_away_from_checkpoints":
            statistics.median(quiet) if quiet else None,
        "steps_away_from_checkpoints": len(quiet),
        "train_phase_step_ms_median": train_step_ms,
        "restored_state_bit_identical": same_state,
        "replayed_loss_bit_identical": replay,
        "replayed_next_loss_bit_identical": replay_next,
        "free_disk_bytes_before": free0, "tmpdir": tmp,
        "bytes_written": sum(w["bytes"] for w in log["writes"]),
        "saves": log["saves"], "writes": log["writes"],
        "restores": log["restores"], "launches": got}
    print(f"  state restored at step {ckpt_every} bit-identical to the saved "
          f"one: {same_state}; replayed steps {ckpt_every} and "
          f"{ckpt_every + 1} losses bit-identical: {replay}, {replay_next}")
    print(f"  free disk under {tmp} before: {free0 / 1e9:.1f} GB; written "
          f"{out['bytes_written'] / 1e9:.2f} GB in "
          f"{len(log['writes'])} checkpoints; snapshot s "
          f"{[round(v['snapshot_s'], 3) for v in log['saves']]}, wait s "
          f"{[round(v['wait_s'], 3) for v in log['saves']]}, async write s "
          f"{[round(w['write_s'], 3) for w in log['writes']]}, restore s "
          f"{[round(r['restore_s'], 3) for r in log['restores']]}")
    print(f"  step ms: median {out['step_ms_median_all']:.1f} (steps "
          f"after the first), {out['step_ms_median_away_from_checkpoints']}"
          f" over the {len(quiet)} steps that overlap no save or write; "
          f"the train phase's median {train_step_ms:.1f}")
    return out, got


def trace_check(cfg, train_step_ms: float, want_mm=None):
    """One whole train step of ``cfg`` at the training shape traced on
    the meta device (``repro_torch.core.analyze``): one trace op per
    kernel call of a step (``step_launches``) and, where ``want_mm`` is
    given, matrix-product FLOPs equal to it; the step SIMULATED on one
    chip with the reference's v5e ChipSpec and with the H100's datasheet,
    beside ``train_step_ms``, the measured step."""
    import torch
    from repro_torch.core import (ChipSpec, SystemSpec, analyze, build_terms,
                                  cost_analysis, matmul_flops, simulate)
    from repro_torch.core.hlo import kernel_ops
    from repro_torch.models import api
    from repro_torch.sharding import umode
    from repro_torch.train import optim
    t0 = time.perf_counter()
    state = optim.init_state(api.init(0, cfg, device="meta"))
    batch = {k: torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64,
                            device="meta") for k in ("tokens", "targets")}
    cost = analyze(umode.make_train_step(cfg, optim.OptConfig()), state,
                   batch)
    trace_s = time.perf_counter() - t0
    traced_kernels = kernel_ops(cost.trace)
    per_step = step_launches(cfg)
    check(traced_kernels == per_step, f"traced kernel ops {traced_kernels}, "
                                      f"the launch counters' step {per_step}")
    if want_mm is not None:
        check(matmul_flops(cost) == want_mm, f"traced matmul FLOPs "
              f"{matmul_flops(cost)}, from the config {want_mm}")
    sims = {}
    for label, chip in (("v5e (the reference's default ChipSpec)",
                         ChipSpec()), ("h100-sxm datasheet", ChipSpec(
                             **H100_CHIP))):
        spec = SystemSpec(chip=chip, pod_shape=(1, 1))
        terms = build_terms(f"{cfg.name}/train-step", "(1,1)", 1,
                            cost_analysis(cost), cost, spec)
        sim = simulate(cost=cost, spec=spec, device_limit=1)
        sims[chip.name] = {"label": label, "sim_step_ms": sim.time_s * 1e3,
                           "compute_util": sim.compute_util,
                           "t_compute_ms": terms.t_compute * 1e3,
                           "t_memory_ms": terms.t_memory * 1e3,
                           "dominant": terms.dominant}
        print(f"  SIMULATED (not measured) step on one {label}: "
              f"{sim.time_s * 1e3:.3f} ms (util {sim.compute_util:.3f}; "
              f"compute {terms.t_compute * 1e3:.3f} ms, memory "
              f"{terms.t_memory * 1e3:.3f} ms, {terms.dominant}-bound)")
    check(all(v["sim_step_ms"] > 0 for v in sims.values()),
          f"simulated steps {sims}")
    ratio = sims["h100-sxm"]["sim_step_ms"] / train_step_ms
    print(f"  traced one train step on meta in {trace_s:.2f} s: "
          f"{len(cost.trace)} ops, {cost.flops:.4g} FLOPs "
          f"({matmul_flops(cost):.4g} in matrix products), "
          f"{cost.hbm_bytes:.4g} HBM bytes, kernel ops {traced_kernels}")
    print(f"  simulated h100-sxm step / the measured median step "
          f"({train_step_ms:.1f} ms): {ratio:.3f}")
    return {"trace_s": trace_s, "trace_ops": len(cost.trace),
            "kernel_ops": traced_kernels, "flops": cost.flops,
            "matmul_flops": matmul_flops(cost), "hbm_bytes": cost.hbm_bytes,
            "simulated": sims, "measured_step_ms": train_step_ms,
            "simulated_over_measured_h100": ratio}


def phase_loop(train_step_ms: float):
    """Phase 9.  Returns ({"loop", "analysis", "quickstart"}, launches of
    the loop's run by kernel)."""
    import importlib.util
    import numpy as np
    import torch
    from repro_torch.models import get_config
    print(f"== phase 9: fault-tolerant loop and cost analysis, {TRAIN_ARCH} "
          f"at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    loop_out, got = loop_check(cfg, LOOP_STEPS, LOOP_CKPT_EVERY,
                               LOOP_FAULT_STEP, LOOP_REMESH_STEP,
                               train_step_ms)

    # (b) the cost front end.  Matrix products: forward, dX and dW; then
    # the chunked loss's checkpointed chunks make their logits again in
    # the backward: one more unembedding forward
    d = cfg.d_model
    mm_params = cfg.num_layers * (d * (2 * cfg.q_dim + 2 * cfg.kv_dim)
                                  + 3 * d * cfg.d_ff) + d * cfg.padded_vocab
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want_mm = 3 * 2 * mm_params * tokens + 2 * tokens * d * cfg.padded_vocab
    analysis = trace_check(cfg, train_step_ms, want_mm)

    # (c) the quickstart on the card
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    q_report, q_done, q_terms, q_sim = quick.main(device="cuda")
    check(q_report.final_step == 20 and len(q_done) == 4
          and np.isfinite(q_report.final_loss) and q_sim.time_s > 0,
          "the quickstart did not finish")
    quickstart = {"final_loss": q_report.final_loss, "served": len(q_done),
                  "flops": q_terms.flops_per_device,
                  "hbm_bytes": q_terms.hbm_bytes_per_device,
                  "sim_step_ms_v5e": q_sim.time_s * 1e3}
    gc.collect()
    torch.cuda.empty_cache()
    return {"loop": loop_out, "analysis": analysis,
            "quickstart": quickstart}, got


def phase_mamba():
    """Phase 10: phases 8 and 9 for mamba2-1.3b.  Returns ({"train",
    "loop", "analysis"}, launches of the 20-step run by kernel, launches
    of the loop's run by kernel)."""
    import torch
    from repro_torch.models import get_config
    train, train_launches = phase_train(MAMBA_ARCH, 10)
    step_ms = train["steps"]["step_ms_median"]
    print(f"== phase 10 (d), (e): fault-tolerant loop and cost analysis, "
          f"{MAMBA_ARCH} at full width", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MAMBA_ARCH)
    loop_out, loop_launches = loop_check(
        cfg, MAMBA_LOOP_STEPS, LOOP_CKPT_EVERY, LOOP_FAULT_STEP, None,
        step_ms)
    analysis = trace_check(cfg, step_ms)
    gc.collect()
    torch.cuda.empty_cache()
    return ({"train": train, "loop": loop_out, "analysis": analysis},
            train_launches, loop_launches)


# phase 11: the simulator's parallel engine on the card's host.  It runs
# in two child interpreters that never create a CUDA context: the procs
# executor forks its shard workers, and a process that holds a CUDA
# context and torch's threads must not fork.  The first traces on meta,
# the second simulates; either's non-zero exit fails the run.
SIM_SCHEDULERS = ("batch", "lookahead", "bounded")
SIM_EXECUTORS = ("threads", "procs")
SIM_SERVE_SCHEDULER = "bounded"     # (b): serial and this one x both
SIM_CHILD_TIMEOUT_S = 420
SIM_DEVICE_LIMIT = 8                # phase 7's (all 4 MGMark chips)
# (a) also: the diverged ring of benchmarks/engine_scalability.py, whose
# BENCH_engine.json (a CPU host) has lookahead at 4 workers taking 0.73
# of serial's wall time: JitterNodes, a 4 ns link to the next, best of
# SIM_RING_REPEAT
SIM_RING_NODES, SIM_RING_TICKS, SIM_RING_WORKERS, SIM_RING_REPEAT = \
    32, 1200, 4, 3
# (b) phase 3's traffic: one tenant on one H100, 4 slots, prompts of
# 64-1000 tokens, 32 new tokens each; 16 Poisson arrivals (1000 a second
# over 16 ms; seed 5 gives 16), as phase 3 serves 16 requests
SIM_SERVE_TRAFFIC = dict(arrival="poisson", rate_rps=1000.0,
                         duration_s=0.016, seed=5, tenants=1, slots=4,
                         prompt_range=(64, 1000), decode_range=(32, 32))
# a failover scenario as tests/test_serve_failover.py builds one: one
# tenant on a 2x2 pod, a second chip lost while the first recovers
SIM_FAILOVER = dict(rate_rps=800.0, duration_s=0.006, seed=3, tenants=1)
SIM_FAILOVER_FAULTS = {"chip1.prog": [(3e-3, "fail", None)],
                       "chip2.prog": [(3.4e-3, "fail", None)]}
SIM_FAILOVER_DEADLINE_S = 5e-4


def _sim_traces(tmp: pathlib.Path, small: bool = False) -> None:
    """Phase 11's first child: phase 9(b)'s train step and phase 7's
    MGMark programs at ``default_size(4)``, traced on meta, pickled to
    ``tmp/traces.pkl`` (``small``: the smoke config and size 256, for a
    run on a CPU host)."""
    import pickle
    import torch
    from repro_torch.core import analyze
    from repro_torch.models import api, get_config
    from repro_torch.patterns import WORKLOADS, Mesh
    from repro_torch.patterns.base import MODES, trace
    from repro_torch.sharding import umode
    from repro_torch.train import optim
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH + ("-smoke" if small else ""))
    shape = (2, 64) if small else (TRAIN_BATCH, TRAIN_SEQ)
    state = optim.init_state(api.init(0, cfg, device="meta"))
    batch = {k: torch.zeros(shape, dtype=torch.int64, device="meta")
             for k in ("tokens", "targets")}
    traces = {"train": analyze(umode.make_train_step(cfg, optim.OptConfig()),
                               state, batch)}
    mesh = Mesh(["cpu"] * MGMARK_SHARDS)
    for name, mod in WORKLOADS.items():
        args = mod.make_args(256 if small else mod.default_size(MGMARK_SHARDS))
        if name == "aes":                   # round keys and S-box, no key
            plain, _key, rk, sb = args
            args = (plain, rk, sb)
        for mode in MODES:
            traces[f"{name}/{mode}"] = trace(
                getattr(mod, f"make_{mode}")(mesh), args)
    (tmp / "traces.pkl").write_bytes(pickle.dumps(traces))
    print(f"  traced {cfg.name}'s train step ({len(traces['train'].trace)} "
          f"ops) and {len(traces) - 1} MGMark programs on meta in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _sim_runs(tmp: pathlib.Path) -> None:
    """Phase 11's second child: (a) each trace under serial and under
    every round scheduler x executor, (b) the serving simulator, (c) the
    sweep; every summary must equal serial's on the same fabric.  Writes
    the numbers to ``tmp/phase11.json``."""
    import os
    import pickle
    import platform
    import tempfile
    from repro_torch.core import ChipSpec, SystemSpec, simulate
    from repro_torch.models import get_config
    from repro_torch.serve import sim as serve_sim
    sys.path.insert(0, str(ROOT))
    from tools import torch_sweep
    traces = pickle.loads((tmp / "traces.pkl").read_bytes())
    combos = [("serial", None)] + [(s, e) for s in SIM_SCHEDULERS
                                   for e in SIM_EXECUTORS]
    h100 = ChipSpec(**H100_CHIP)
    cpu = [ln.split(":", 1)[1].strip() for ln in pathlib.Path(
        "/proc/cpuinfo").read_text().splitlines()
        if ln.startswith("model name")] or [
            f"{platform.machine()}, model not reported"]
    out = {"cpu_count": os.cpu_count(), "cpu_model": cpu[0],
           "traces": {}, "wall_s": {}}
    print(f"  host: {os.cpu_count()} CPUs ({cpu[0]})", flush=True)

    # (a) every trace under every scheduler x executor
    wall: dict = {}
    for key, cost in traces.items():
        one = key == "train"
        spec = SystemSpec(chip=h100, pod_shape=(1, 1) if one
                          else (1, MGMARK_SHARDS))
        row = {}
        for fabric in ("analytic",) if one else ("analytic", "event"):
            oracle = None
            for sched, ex in combos:
                t0 = time.perf_counter()
                rep = simulate(cost=cost, spec=spec, scheduler=sched,
                               executor=ex, fabric=fabric,
                               device_limit=1 if one else SIM_DEVICE_LIMIT)
                dt = time.perf_counter() - t0
                label = sched if ex is None else f"{sched}/{ex}"
                wall.setdefault(fabric, {}).setdefault(label, 0.0)
                wall[fabric][label] += dt
                if oracle is None:
                    oracle = rep.summary()
                    row[fabric] = {"sim_ms": rep.time_s * 1e3,
                                   "events": rep.events}
                check(rep.summary() == oracle,
                      f"phase 11 (a): {key} on {fabric} under {label} "
                      f"differs from serial")
        out["traces"][key] = row
    out["wall_s"] = wall
    for fabric, by in wall.items():
        print(f"  (a) wall s over {len(traces)} traces on {fabric}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in by.items()), flush=True)
    out["ring"] = _sim_ring(combos)
    print(f"  (a) wall s of the diverged ring ({SIM_RING_NODES} nodes x "
          f"{SIM_RING_TICKS} ticks, {SIM_RING_WORKERS} workers, best of "
          f"{SIM_RING_REPEAT}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in out["ring"].items()), flush=True)

    # (b) the serving simulator
    def serve(scen, spec, **kw):
        runs = {}
        for fabric in ("analytic", "event"):
            oracle = None
            for sched, ex in [("serial", None)] + [
                    (SIM_SERVE_SCHEDULER, e) for e in SIM_EXECUTORS]:
                t0 = time.perf_counter()
                rep = serve_sim.run_serving(scen, spec=spec, fabric=fabric,
                                            scheduler=sched, executor=ex,
                                            **kw)
                label = sched if ex is None else f"{sched}/{ex}"
                runs[f"{fabric}/{label}"] = time.perf_counter() - t0
                if oracle is None:
                    oracle, first = rep.summary(), rep
                check(rep.summary() == oracle,
                      f"phase 11 (b): {scen.name} on {fabric} under "
                      f"{label} differs from serial")
            runs[f"{fabric}/report"] = first
        return runs
    spec1 = SystemSpec(chip=h100, pod_shape=(1, 1))
    scen = serve_sim.build_scenario(spec1, name="qwen2-1.5b",
                                    model=get_config(TRAIN_ARCH),
                                    **SIM_SERVE_TRAFFIC)
    runs = serve(scen, spec1)
    new_tokens = sum(r.decode_len for t in scen.tenants for r in t.requests)
    out["serve"] = {}
    for fabric in ("analytic", "event"):
        rep = runs.pop(f"{fabric}/report")
        check(rep.completed == rep.offered > 0,
              f"phase 11 (b): {rep.completed} of {rep.offered} served")
        out["serve"][fabric] = {
            "requests": rep.offered, "new_tokens": new_tokens,
            "sim_s": rep.time_s, "sim_tokens_per_s": new_tokens / rep.time_s,
            "p50_s": rep.p50_s, "p99_s": rep.p99_s}
    out["serve"]["wall_s"] = runs
    spec4 = SystemSpec(pod_shape=(2, 2))
    fo = serve(serve_sim.build_scenario(spec4, **SIM_FAILOVER), spec4,
               deadline_s=SIM_FAILOVER_DEADLINE_S, recovery=True,
               faults=SIM_FAILOVER_FAULTS)
    rep = fo.pop("analytic/report")
    fo.pop("event/report")
    check(rep.chip_deaths == 2 and rep.completed + rep.dropped
          == rep.offered, f"phase 11 (b): failover {rep.chip_deaths} "
                          f"deaths, {rep.completed} + {rep.dropped} of "
                          f"{rep.offered}")
    out["failover"] = {"chip_deaths": rep.chip_deaths,
                       "retries": rep.retries, "completed": rep.completed,
                       "offered": rep.offered, "wall_s": fo}

    # (c) the sweep's quick grid: inline, then two workers from the plan
    # cache the inline run wrote
    with tempfile.TemporaryDirectory(dir=tmp) as d:
        cache = os.path.join(d, "plans")
        grid = torch_sweep.GRIDS["quick"]
        t0 = time.perf_counter()
        inline = torch_sweep.run_sweep(grid, out=os.path.join(d, "a.json"),
                                       workers=0, cache_dir=cache,
                                       quiet=True)
        t1 = time.perf_counter()
        pool = torch_sweep.run_sweep(grid, out=os.path.join(d, "b.json"),
                                     workers=2, cache_dir=cache, quiet=True)
        t2 = time.perf_counter()
        rows = [torch_sweep.load_results(os.path.join(d, f))["rows"]
                for f in ("a.json", "b.json")]
    skip = ("wall_s", "plan_lookups", "plan_misses")
    check(inline["errors"] == pool["errors"] == 0 and rows[0].keys()
          == rows[1].keys() and all(
              {k: v for k, v in rows[0][c].items() if k not in skip}
              == {k: v for k, v in rows[1][c].items() if k not in skip}
              for c in rows[0]),
          "phase 11 (c): the pool's rows differ from the inline rows")
    check(pool["plan_cache_lookups"] > 0
          and pool["plan_cache_hit_rate"] == 1.0,
          f"phase 11 (c): the rerun's plan-cache hit rate "
          f"{pool['plan_cache_hit_rate']} of {pool['plan_cache_lookups']}")
    out["sweep"] = {"configs": inline["grid_points"],
                    "inline_s": t1 - t0, "pool_s": t2 - t1,
                    "pool_plan_hit_rate": pool["plan_cache_hit_rate"],
                    "inline_plan_hit_rate": inline["plan_cache_hit_rate"]}
    (tmp / "phase11.json").write_text(json.dumps(out))


def _sim_ring(combos) -> dict:
    """The diverged ring of benchmarks/engine_scalability.py on the
    port's engine: best-of wall seconds by scheduler x executor, every
    run's node state equal to serial's."""
    import random
    from repro_torch.core import Component, Connection, Engine, Request

    class JitterNode(Component):
        """benchmarks/engine_scalability.py's device-analog: op
        latencies that diverge across nodes, a ping every 40 ticks."""

        def __init__(self, name, seed, ticks, send_every=40):
            super().__init__(name)
            self.rng = random.Random(seed)
            self.ticks, self.send_every = ticks, send_every
            self.count = self.received = self.sig = 0

        def start(self):
            self.schedule("tick", self.rng.randint(50, 550))

        def handle(self, event):
            self.sig = hash((self.sig, self.engine.now, event.kind))
            if event.kind == "tick":
                self.count += 1
                if self.count % self.send_every == 0:
                    self.port("out").send(Request(src=self.port("out"),
                                                  dst=None, kind="ping",
                                                  size_bytes=64))
                if self.count < self.ticks:
                    self.schedule("tick", self.rng.randint(50, 550))
            else:
                self.received += 1

    n, oracle, best = SIM_RING_NODES, None, {}
    for sched, ex in combos:
        label = sched if ex is None else f"{sched}/{ex}"
        for _ in range(SIM_RING_REPEAT):
            eng = Engine(scheduler=sched, executor=ex,
                         max_workers=SIM_RING_WORKERS)
            nodes = [eng.register(JitterNode(f"n{i}", i, SIM_RING_TICKS))
                     for i in range(n)]
            for i in range(n):
                conn = eng.register(Connection(f"ring{i}", latency_s=4e-9))
                conn.plug(nodes[i].port("out")).plug(
                    nodes[(i + 1) % n].port("in"))
            for nd in nodes:
                nd.start()
            t0 = time.perf_counter()
            end = eng.run()
            dt = time.perf_counter() - t0
            state = (end, eng.events_processed,
                     [(nd.sig, nd.count, nd.received) for nd in nodes])
            oracle = oracle or state
            check(state == oracle, f"phase 11 (a): the diverged ring under "
                                   f"{label} differs from serial")
            best[label] = min(best.get(label, dt), dt)
    return best


def sim_child(stage: str, tmp: str, small: bool = False) -> None:
    """Entry of phase 11's child interpreters."""
    if stage == "trace":
        _sim_traces(pathlib.Path(tmp), small)
    else:
        _sim_runs(pathlib.Path(tmp))


def _run_sim_child(stage: str, tmp: pathlib.Path) -> None:
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]), OMP_NUM_THREADS="1",
        OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
        CUDA_VISIBLE_DEVICES="")
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.sim_child({stage!r}, {str(tmp)!r})"],
        cwd=ROOT, env=env, timeout=SIM_CHILD_TIMEOUT_S)
    check(proc.returncode == 0,
          f"phase 11's {stage} child exited {proc.returncode}")


def phase_sim(serve_tokens_per_s: float, mgmark_sim: dict) -> dict:
    """Phase 11.  ``serve_tokens_per_s``: phase 3's measured tok/s;
    ``mgmark_sim``: phase 7's simulated ms by run.  Returns the phase's
    numbers."""
    import tempfile
    print("== phase 11: the simulator's parallel engine on the card's host "
          "(child interpreters, no CUDA context)", flush=True)
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = pathlib.Path(d)
        _run_sim_child("trace", tmp)
        _run_sim_child("simulate", tmp)
        out = json.loads((tmp / "phase11.json").read_text())
    for key, row in out["traces"].items():
        if key == "train":
            print(f"  {TRAIN_ARCH} train step SIMULATED on one h100-sxm: "
                  f"{row['analytic']['sim_ms']:.3f} ms (phase 9(b)'s "
                  f"trace, simulated again)")
            continue
        phase7 = mgmark_sim.get(key, {}).get("h100-sxm")
        print(f"  {key} SIMULATED on 4 h100-sxm: analytic "
              f"{row['analytic']['sim_ms']:.6f} ms, event "
              f"{row['event']['sim_ms']:.6f} ms (phase 7, analytic: "
              f"{phase7 if phase7 is None else f'{phase7:.6f}'} ms)")
        # the same program traced again, on the same spec: the same time
        check(phase7 is None or phase7 == row["analytic"]["sim_ms"],
              f"phase 11: {key}'s trace simulates to "
              f"{row['analytic']['sim_ms']} ms, phase 7's to {phase7}")
    for fabric in ("analytic", "event"):
        s = out["serve"][fabric]
        print(f"  (b) qwen2-1.5b serving SIMULATED on one h100-sxm "
              f"({fabric}): {s['sim_tokens_per_s']:.1f} tok/s, "
              f"{s['new_tokens']} tokens of {s['requests']} requests in "
              f"{s['sim_s'] * 1e3:.3f} ms, p99 {s['p99_s'] * 1e3:.3f} ms; "
              f"phase 3 measured {serve_tokens_per_s:.1f} tok/s")
    print(f"  (b) wall s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["serve"]["wall_s"].items()))
    print(f"  (b) failover: {out['failover']['chip_deaths']} chips lost, "
          f"{out['failover']['completed']} of {out['failover']['offered']} "
          f"served, {out['failover']['retries']} retries; wall s "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in out["failover"]["wall_s"].items()))
    sw = out["sweep"]
    print(f"  (c) sweep: {sw['configs']} configs inline in "
          f"{sw['inline_s']:.2f} s, with 2 workers in {sw['pool_s']:.2f} s, "
          f"rows equal, plan-cache hit rate {sw['pool_plan_hit_rate']:.2f}")
    out["seconds"] = time.perf_counter() - t0
    out["phase3_tokens_per_s"] = serve_tokens_per_s
    print(f"  phase 11: {out['seconds']:.1f} s on {out['cpu_count']} CPUs "
          f"({out['cpu_model']})", flush=True)
    return out


def _paths(tree, prefix=()):
    """The key paths of a nested dict, in ``optim.leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 means f32
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    sass = phase_build()
    cases = phase_kernels()
    serve = {}
    for arch, phase in (("qwen2-1.5b", 3), ("mamba2-1.3b", 5)):
        serve[arch] = phase_serve(arch, phase)
        phase_f32(arch, phase + 1)
    mgmark_rows, mgmark_launches, mgmark_sim = phase_mgmark()
    train, train_launches = phase_train(TRAIN_ARCH, 8)
    loop_phase, loop_launches = phase_loop(train["steps"]["step_ms_median"])
    mamba, mamba_train_launches, mamba_loop_launches = phase_mamba()
    sim = phase_sim(serve["qwen2-1.5b"]["tokens_per_s"],
                    {f"{r['name']}/{r['mode']}": r["sim_ms"]
                     for r in mgmark_rows})
    # (shape, dtype) of each kernel's row in the kernels line
    H, W, K, _ = STENCIL_CASES[0]
    L, size, dist, _, _ = BITONIC_CASES[0]
    main_case = {"flash_attention": (f"S={PROBE_LEN}", "bfloat16"),
                 "rmsnorm": ("rows=4", "bfloat16"),
                 "add_rmsnorm": (f"rows=4,d={ADD_NORM_DIMS[0]}", "bfloat16"),
                 "gated_rmsnorm": (f"rows=4,d={GATED_NORM_DIM}", "bfloat16"),
                 "ssd_chunk_kernel": (SSD_CASES[0][0], "float32"),
                 "stencil2d": (f"{H}x{W},K={K}", "float32"),
                 "bitonic_stage": (f"L={L},size={size},dist={dist}",
                                   "float32"),
                 "bitonic_block": ("L={},size={}".format(
                     *BITONIC_BLOCK_CASES[0][:2]), "float32"),
                 "flash_attention_bwd": ("B={},S={},hd={}".format(
                     *(FLASH_BWD_CASES[0][i] for i in (0, 1, 4))),
                     "bfloat16"),
                 "rmsnorm_bwd": ("rows={},d={}".format(*RMS_BWD_SHAPE),
                                 "bfloat16"),
                 "add_rmsnorm_bwd": ("rows={},d={}".format(*RMS_BWD_SHAPE),
                                     "bfloat16"),
                 "gated_rmsnorm_bwd": ("rows={},d={}".format(
                     *GATED_BWD_SHAPE), "bfloat16"),
                 "ssd_chunk_bwd": (SSD_BWD_CASES[0][0], "float32")}
    source = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                  "src/repro/kernels/flash_attention.py:76"),
              "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                          "src/repro/kernels/rmsnorm.py:27"),
              "add_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                              "src/repro/kernels/rmsnorm.py:27"),
              "gated_rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                                "src/repro/kernels/rmsnorm.py:27"),
              "ssd_chunk_kernel": ("src/repro_torch/kernels/csrc/ssd.cu",
                                   "src/repro/kernels/ssd.py:50"),
              "stencil2d": ("src/repro_torch/kernels/csrc/stencil.cu",
                            "src/repro/kernels/stencil.py:46"),
              "bitonic_stage": ("src/repro_torch/kernels/csrc/bitonic.cu",
                                "src/repro/kernels/bitonic.py:40"),
              "bitonic_block": ("src/repro_torch/kernels/csrc/bitonic.cu",
                                "src/repro/kernels/bitonic.py:40"),
              # the backward kernels have no TPU counterpart: they are the
              # gradients of the forward kernels these lines name
              "flash_attention_bwd": (
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                  "src/repro/kernels/flash_attention.py:76"),
              "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                              "src/repro/kernels/rmsnorm.py:27"),
              "add_rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                                  "src/repro/kernels/rmsnorm.py:27"),
              "gated_rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                                    "src/repro/kernels/rmsnorm.py:27"),
              "ssd_chunk_bwd": ("src/repro_torch/kernels/csrc/ssd_bwd.cu",
                                "src/repro/kernels/ssd.py:50")}
    kernels = []
    for kname, rows in cases.items():
        main_row = next(r for r in rows
                        if (r["shape"], r["dtype"]) == main_case[kname])
        by_path = {arch: run["launches"][kname]
                   for arch, run in serve.items()}
        by_path["mgmark"] = mgmark_launches[kname]
        by_path["train"] = train_launches[kname]
        by_path["loop"] = loop_launches.get(kname, 0)
        by_path["mamba_train"] = mamba_train_launches[kname]
        by_path["mamba_loop"] = mamba_loop_launches.get(kname, 0)
        kernels.append({
            "name": kname, "route": "cuda", "source": source[kname][0],
            "replaces": source[kname][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "shape", "dtype")},
            **({"direction": "backward"} if kname.endswith("_bwd") else {}),
            **{k: main_row[k] for k in ("library", "library_calls",
                                        "bound_ms_f32", "lse_max_abs_err",
                                        "max_err_over_max_value",
                                        "sort_ms", "torch_sort_ms",
                                        "sort_launches")
               if k in main_row},
            **({"launch_ms": main_row["launch_ms"]}
               if "launch_ms" in main_row else {}),
            "max_abs_err_all_cases": max(r["max_abs_err"] for r in rows),
            "sass": sass.get(source[kname][0].split("/")[-1][:-3]),
            "cases": rows})
    out = ROOT / "build"                        # git-ignored
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "kernels": kernels, "serve": serve,
         "mgmark": mgmark_rows, "mgmark_simulated": mgmark_sim,
         "train": train, **loop_phase, "mamba": mamba, "sim": sim,
         "seconds": time.perf_counter() - t0},
        indent=1))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
