"""The first vector-math call of a torch CPU process, made on one thread.

torch's CPU build takes exp, log, erf, tanh and the other vector-math
functions of contiguous f32 and f64 tensors from MKL's VML: its torch.exp
equals ``vmsExp(..., VML_HA)`` bit for bit.  MKL chooses its CPU kernels
lazily, in the first VML call of the process.  When that first call is
one of torch's parallel ones (a tensor above torch's grain of 2048
elements, cut among the OpenMP threads, each calling VML on its chunk),
the threads race that choice, and a thread may take its whole chunk
through VML's AVX2 "enhanced performance" kernel (about 11 correct bits:
a relative error up to 1.5e-4) in place of the AVX-512 high-accuracy one.
The wrong chunk equals that kernel's output bit for bit
(``MKL_ENABLE_INSTRUCTIONS=AVX2``, ``VML_EP``).

``tools/torch_vml_probe.py`` measures it: on a torch 2.13.0+cpu build
(MKL 2024.2, AVX-512, 8 threads), a fresh process whose first VML call is
torch.exp of 16384 f32 elements was wrong in 5 and 6 of 120 processes
in two runs, every wrong value that kernel's; in 0 of 120 with
OMP_NUM_THREADS=1; in 4 of 120 with ATEN_CPU_CAPABILITY=avx2 (ATen's
own dispatch is not what races); in 0 of 120 after one VML call on one
thread.  Neither JAX nor the port is needed to show it.  It is torch's runtime, not the port's
arithmetic, so the port's tests make one small VML call before anything
else: a tensor below the grain is not split among threads.
"""
import torch


def init_vml() -> None:
    """Make the process's first VML call on one thread (idempotent)."""
    torch.exp(torch.zeros(16, dtype=torch.float32))
