"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/*.cu`` (and the ``*.cuh`` they
include) have a plain C interface (no PyTorch headers), so each
compiles in seconds.  At first use every
source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library under
``build/torch_kernels/<hash>/`` at the repository root.  The directory
is keyed on a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused.  The library is loaded with
``ctypes``; every pointer and the CUDA stream pass as ``c_void_p``, and
every entry point returns ``cudaGetLastError()``, which
:func:`launch` turns into an exception.

Nothing here runs at import time: the CPU tests import every module on
hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "library", "launch", "ptr"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = (
    "cow_write.cu",
    "refcount_update.cu",
    "cow_gather.cu",
    "clone_chain.cu",
    "paged_attention.cu",
    "resample.cu",
    "flash_attention.cu",
    "ssd_scan.cu",
    "flash_attention_bwd.cu",
    "ssd_scan_bwd.cu",
)
HEADERS = ("refcount_hist.cuh", "comb.cuh", "comb_range.cuh", "column_runs.cuh", "wgmma.cuh", "ssd_mma.cuh")
# No --use_fast_math: clone_chain's comb positions need IEEE division
# to match the plain path bit for bit.
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
LIB_NAME = "librepro_torch_kernels.so"


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  A no-op when the hashed build already exists.
    ``build.log`` beside the library keeps ptxas' register report."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append(
                (name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        log = []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        link = [nvcc, "-shared", "-o", str(tmp / LIB_NAME)]
        link += [str(obj) for _, obj, _ in procs]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        (tmp / "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return ctypes.CDLL(str(build()))


def launch(
    name: str, argtypes: Sequence[type], device: torch.device, *args: object
) -> None:
    """Call C entry point ``name`` on ``device`` and raise if it reports
    a CUDA error (a refused launch never runs, and a later synchronize
    would not report it).  The last argument of every entry point is the
    stream; it is appended here."""
    fn = getattr(library(), name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        cuda_stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = fn(*args, cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
