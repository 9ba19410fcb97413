"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source file has a plain C interface: a host function per kernel that
launches it on the stream it is given and returns the ``cudaError_t`` of the
launch. The file is compiled with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared`` at first use into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the source, the
shared headers (``csrc/*.cuh``), the flags and the compiler, so an unchanged
source is built once. ``build_all`` starts one nvcc per source, all at once.
The library is loaded with ``ctypes``. A failed build or a failed launch
raises.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import torch

__all__ = ["CudaKernel", "build_all", "check_cuda_tensor", "KERNELS"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# Every kernel wrapper of the package, by name (filled as modules import).
KERNELS: dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (looked in /usr/local/cuda/bin and on PATH): the CUDA "
        "kernels are built from source at first use"
    )


class _Library:
    """One ``.cu`` file built into a shared library and loaded once."""

    def __init__(self, source: str, flags: Sequence[str] = ()):
        self.source = CSRC_DIR / source
        self.flags = tuple(flags)
        self._lib: ctypes.CDLL | None = None
        self.build_seconds = 0.0
        self.build_log = ""  # what nvcc printed (ptxas -v: registers, stack, spills per kernel), kept beside the .so

    def path(self, nvcc: str) -> Path:
        h = hashlib.sha256()
        h.update(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + self.flags).encode())
        h.update(nvcc.encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        nvcc = _nvcc()
        out = self.path(nvcc)
        if out.exists():
            log = out.with_suffix(".log")
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, *BASE_FLAGS, *self.flags, "-o", tmp, str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {self.source.name} (rc={proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        out.with_suffix(".log").write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.sdm_error_string.argtypes = [ctypes.c_int]
            lib.sdm_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


_LIBRARIES: dict[tuple, _Library] = {}


class CudaKernel:
    """A host launch function of one ``csrc`` library, with a launch count.

    ``launches`` grows by one each time the kernel is launched and at no
    other time; ``chip_smoke.py`` resets it to show that a run went through
    the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes, flags: Sequence[str] = ()):
        key = (source, tuple(flags))
        self.library = _LIBRARIES.setdefault(key, _Library(source, flags))
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    @property
    def source(self) -> Path:
        return self.library.source

    def _function(self):
        if self._fn is None:
            lib = self.library.load()
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._function()
        err = fn(*args)
        if err != 0:
            msg = self.library.load().sdm_error_string(err).decode()
            raise RuntimeError(f"{self.name}: kernel launch failed: cudaError {err} ({msg})")
        self.launches += 1


def build_all() -> dict[str, float]:
    """Build (or find built) every kernel library, one nvcc per source run
    side by side, and load each; returns seconds per file. Each library's
    ``build_log`` then holds what ptxas said of its kernels."""
    libs = list(_LIBRARIES.values())
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        list(pool.map(_Library.build, libs))
    out = {}
    for lib in libs:
        lib.load()
        out[lib.source.name] = lib.build_seconds
    return out


def check_cuda_tensor(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (entries of None match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
