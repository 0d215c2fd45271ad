"""Build and bind the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. ``build`` compiles every
source with its own ``nvcc`` process, all started together, into
``build/repro_torch/lib<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists); the hash covers the source, the shared
header and the flags, so an unchanged source is not rebuilt. ``library``
loads one with ``ctypes`` at first use; wrappers declare ``argtypes`` with
``c_void_p`` for every pointer and the stream, so no pointer is cut to 32
bits. Every C entry point returns ``cudaGetLastError()`` after its launch
and :func:`check` raises on a non-zero code, because a refused launch
never runs and a later synchronize does not report it.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "library", "check", "check_operands",
           "launches", "reset_launches", "stream_of"]

#: Every kernel, in the order of the kernel table in PERF.md; ``build``
#: starts one nvcc per source, all together.
SOURCES = ("fwht", "itq3_matvec", "itq3_matmul", "attn_q8",
           "itq3_matvec_int8", "itq3_matmul_int8", "quantize_blocks")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: Kernel launches per wrapper since the last :func:`reset_launches`. A
#: wrapper adds one exactly where it launches its kernel, never on the
#: plain (CPU) path.
launches: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}  # loaded shared objects, one per source


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile ``names`` in parallel (one nvcc each). Returns, per source,
    its build seconds and ptxas report; raises with the compiler output if
    any source fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            procs[name] = None
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, entry in procs.items():
        if entry is None:
            report[name] = {"seconds": 0.0, "ptxas": "(cached)"}
            continue
        proc, tmp, out, t0 = entry
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for source ``name``, built if needed, with
    ``signatures`` ({function: argtypes}) declared; every function returns
    a C int (a ``cudaError_t``)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_operands(what: str, device, operands) -> None:
    """Raise unless every ``(tensor, dtype)`` pair lies on ``device``, has
    its dtype and is contiguous: the layout the kernels read, which the
    plain versions are held to as well."""
    for t, dtype in operands:
        if t.device != device:
            raise ValueError(f"{what}: operand on {t.device}, want {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: operand dtype {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operand of shape {tuple(t.shape)} is "
                             f"not contiguous")


def check(err: int, what: str) -> None:
    """Raise if a C launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
