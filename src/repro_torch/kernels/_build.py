"""nvcc -> ctypes build step shared by the port's CUDA kernels.

Each kernel is a `CudaLibrary`: one source under `repro_torch/csrc/`
with a plain C interface (it may include the shared `csrc/*.cuh`),
compiled with nvcc for sm_90a into a shared library the first time it is
needed, into `build/repro_torch/<hash of the source and headers>/` at the
root of the checkout, and loaded with ctypes. Nothing is built or loaded
at import. `build_all` starts one nvcc per source at once and then waits
for each, so several kernels build in parallel.

A library records its build seconds (None: loaded from an earlier build),
nvcc's ptxas report (`-Xptxas -v`) and a launch count, which
`CudaLibrary.launch` raises by one for every kernel launch. The checks
below are the ones every wrapper makes before it launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.obs.metrics import Stopwatch

PKG = Path(__file__).resolve().parents[1]              # src/repro_torch
BUILD_ROOT = PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the sources' dtype


def check_dtypes(kernel: str, **tensors) -> int:
    """The named activations share one dtype, float32 or bfloat16;
    returns its code for the launch."""
    dtypes = [t.dtype for t in tensors.values()]
    if dtypes[0] not in DTYPE_CODES or len(set(dtypes)) > 1:
        names = ", ".join(tensors)
        raise ValueError(f"{kernel}: {names} must all be float32 or all "
                         f"bfloat16, got {', '.join(map(str, dtypes))}")
    return DTYPE_CODES[dtypes[0]]


def check_fp32(kernel: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} must be float32, got "
                             f"{t.dtype}")


def check_cuda(kernel: str, strided: Sequence[str] = (), **tensors) -> None:
    """Every tensor lies on the first one's CUDA device, and each one not
    named in `strided` is contiguous."""
    first, t0 = next(iter(tensors.items()))
    for name, t in tensors.items():
        if not t.is_cuda or t.device != t0.device:
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor on "
                             f"{first}'s device, got device {t.device}")
        if name not in strided and not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def refuse_grad(kernel: str, **tensors) -> None:
    """A kernel without a backward raises where autograd would need one:
    grad mode on and an input that requires grad. It never detaches the
    output silently and never falls back to its plain version."""
    wanted = [n for n, t in tensors.items()
              if t is not None and t.requires_grad]
    if torch.is_grad_enabled() and wanted:
        raise RuntimeError(
            f"{kernel}: the backward of the CUDA kernel is not ported, and "
            f"{', '.join(wanted)} require grad; run it under "
            "torch.no_grad() or on CPU tensors (the plain version)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit")


class CudaLibrary:
    """One CUDA source built into `lib<name>.so`. `functions` maps each
    exported C function to (argtypes, restype)."""

    def __init__(self, source: str, name: str,
                 functions: Dict[str, tuple]):
        self.source = PKG / "csrc" / source
        self.name = name
        self.functions = functions
        self.lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.ptxas = ""
        self._proc: Optional[subprocess.Popen] = None
        self._sw: Optional[Stopwatch] = None
        self._tmp: Optional[Path] = None

    def _lib_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        return BUILD_ROOT / digest / f"lib{self.name}.so"

    def start(self) -> None:
        """Start nvcc in the background unless the library is loaded,
        already compiling, or built by an earlier run."""
        if self.lib is not None or self._proc is not None:
            return
        lib_path = self._lib_path()
        if lib_path.exists():
            return
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        self._tmp = lib_path.parent / f"lib{self.name}.{os.getpid()}.so"
        self._sw = Stopwatch().start()
        self._proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(self._tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def build(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load; returns the library."""
        if self.lib is not None:
            return self.lib
        self.start()
        lib_path = self._lib_path()
        if self._proc is not None:
            _, err = self._proc.communicate()
            self.build_seconds = self._sw.stop()
            self.ptxas = err.strip()
            code, self._proc = self._proc.returncode, None
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}) on "
                                   f"{self.source}:\n{err}")
            os.replace(self._tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        for fname, (argtypes, restype) in self.functions.items():
            fn = getattr(lib, fname)
            fn.argtypes = list(argtypes)
            fn.restype = restype
        self.lib = lib
        return lib

    def launch(self, function: str, device, *args, at: str = "") -> None:
        """Build if need be, call `function(*args, stream)` on `device`
        with its current stream, raise on a CUDA error, count the launch."""
        lib = self.build()
        with torch.cuda.device(device):    # the library launches on the
            err = getattr(lib, function)(  # thread's current device
                *args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{err} at {at}")
        self.launches += 1


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Start every library's nvcc at once, then wait for each."""
    for lib in libraries:
        lib.start()
    for lib in libraries:
        lib.build()
