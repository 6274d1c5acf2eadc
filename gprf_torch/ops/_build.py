"""Build and bind the hand-written CUDA kernels of ``gprf_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them straight
into one shared library (seconds, where a build that includes PyTorch's
headers takes minutes) and :mod:`ctypes` binds it.  The library is built at
first use into ``gprf_torch/csrc/build/<hash>/``, keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads.
Nothing here runs at import: this module is imported on machines with no
CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the exported C functions (pointers, sizes, stream)
SIGNATURES = {
    "gprf_chol_inv": (_P, _P, _P, _I, _I, _P),
    "gprf_mvn_ll": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gprf_tri_inv": (_P, _P, _I, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time; 0.0 when the library was already built
    log: str  # nvcc's output (register and shared-memory use per kernel)


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (if needed) and load the kernel library; raises on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libgprf_kernels.so"
    seconds, log = 0.0, ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".libgprf_kernels.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(p) for p in srcs if p.suffix == ".cu"]]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gprf_error_string.argtypes = (ctypes.c_int,)
    lib.gprf_error_string.restype = ctypes.c_char_p
    return Built(lib=lib, path=so, seconds=seconds, log=log)


def call(name: str, *args) -> None:
    """Launch one exported kernel; raise if the launch was refused."""
    lib = load().lib
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.gprf_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
