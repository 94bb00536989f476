"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each kernel is one ``csrc/*.cu`` file with plain C launch functions,
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``kernels/build/`` (listed in ``.gitignore``). The library name carries
a digest of the sources and flags, so an edited kernel is rebuilt and a
stale one is never loaded. Nothing is built on import: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Mapping, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin): the "
        "CUDA kernels of repro_torch are built from source at first use")


class CudaLibrary:
    """One kernel's shared library, its C launch functions and its count
    of launches.

    ``entries`` maps each C launch function to its ctypes argument
    types; every launch function takes the CUDA stream it enqueues on as
    its last argument. ``launches`` is bumped by :meth:`launch` after
    each kernel was enqueued without error, and nowhere else, so a run
    can show that its main path went through the kernel;
    ``stream_launches`` counts the same launches by stream handle."""

    def __init__(self, name: str, source: str,
                 entries: Mapping[str, Sequence]):
        self.name = name
        self.source = CSRC / source
        self.entries = {sym: list(types) for sym, types in entries.items()}
        self.launches = 0
        self.stream_launches: Counter = Counter()
        self.build_log = ""
        self._fns = None
        self._err_str = None

    def _digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(CSRC.glob("*.cuh")) + [self.source]:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self._digest()}.so"

    def start_build(self):
        """Start ``nvcc`` for this library (``None`` if already built).
        Returns ``(process, temp_path)``; :meth:`finish_build` waits."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.path)

    def _load(self) -> dict:
        if self._fns is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.path))
            fns = {}
            for sym, argtypes in self.entries.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[sym] = fn
            err_str = getattr(lib, self.name + "_error_string")
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fns, self._err_str = fns, err_str
        return self._fns

    def launch(self, entry: str, *args) -> None:
        """Enqueue a kernel through the C launch function ``entry``;
        raise if the launch was refused."""
        err = self._load()[entry](*args)
        if err != 0:
            raise RuntimeError(
                f"{self.name} kernel launch ({entry}) failed: "
                f"{self._err_str(err).decode()} (cudaError {err})")
        self.launches += 1
        self.stream_launches[args[-1]] += 1


def build_all(libraries: Sequence[CudaLibrary]) -> float:
    """Build every library not yet built, one ``nvcc`` per source, all
    started together; returns the wall seconds taken."""
    t0 = time.perf_counter()
    started = [(lib, lib.start_build()) for lib in libraries]
    for lib, st in started:
        lib.finish_build(st)
    return time.perf_counter() - t0
