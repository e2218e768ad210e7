"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded
with ``ctypes``.  Libraries go to ``kernels/_build/`` (git-ignored),
named by a hash of the source and the flags, and are built at first use:
an edited source gets a new library, an unchanged one is reused.  Only
the sources in this package are compiled.  Nothing here runs at import.

Every launcher returns the ``cudaError_t`` of ``cudaGetLastError()``
right after its launch, so a refused launch (too many registers or too
much shared memory) raises in ``check`` instead of passing silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import typing

import torch

# dtype codes of the kernels' C interface (csrc/common.cuh, enum DType)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: typing.Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> typing.List[str]:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(default /usr/local/cuda): cannot build the kernels")


def lib_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: typing.Iterable[str] = None) -> typing.Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: {"path",
    "seconds", "log"}}`` (``log`` holds ptxas's register and spill
    report; ``seconds`` is 0 for a library that was already built).
    Raises RuntimeError on any compile error."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        log = path.with_suffix(".log")
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0,
                         "log": log.read_text() if log.exists() else ""}
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, log, proc))
    errors = []
    for name, path, tmp, log, proc in running:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, path)              # atomic: readers never see half
        out[name] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": text}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str, signatures: typing.Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use, with
    ``signatures`` (``{function: (argtypes, restype)}``) declared on it.
    Pointers and the stream are ``c_void_p``: an undeclared argument would
    be passed as a 32-bit int and cut the pointer."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]["path"]))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher of
    ``lib`` (every library exports ``error_string``)."""
    if err != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
