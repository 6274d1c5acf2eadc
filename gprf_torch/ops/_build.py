"""Build and bind the hand-written CUDA kernels of ``gprf_torch/csrc``.

The sources have a plain C interface, so ``nvcc`` compiles them straight
into one shared library (seconds, where a build that includes PyTorch's
headers takes minutes) and :mod:`ctypes` binds it.  Each ``.cu`` file is
compiled by its own ``nvcc`` process, all started together, and the objects
are then linked.  The library is built at first use into
``gprf_torch/csrc/build/<hash>/``, keyed on a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads.  Nothing
here builds at import: this module is imported on machines with no CUDA
toolkit.  It also holds what every kernel wrapper shares: the launch
counters, the device rule (the twin on the CPU, the kernel on one CUDA
device) and the checks of a kernel's operands.
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

import torch

from gprf_torch.utils.profiling import counter_group

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
# compile flags of each source; the objects are linked with -shared
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of the exported C functions (pointers, sizes, stream; the
# last four are occupancy queries)
SIGNATURES = {
    "gprf_chol_inv": (_P, _P, _P, _I, _I, _P),
    "gprf_mvn_ll": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gprf_tri_inv": (_P, _P, _I, _I, _P),
    "gprf_mvn_ll_inv": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "gprf_cholesky": (_P, _P, _I, _I, _P),
    "gprf_se_kernel": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gprf_se_kernel_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "gprf_chol_inv_ctas_per_sm": (_I,),
    "gprf_tri_inv_ctas_per_sm": (_I,),
    "gprf_mvn_ctas_per_sm": (_I, _I),
    "gprf_mvn_inv_ctas_per_sm": (_I, _I),
}


# Kernel launches per wrapper since the last reset: the "launches" group of
# the port's counters (gprf_torch.utils.profiling).  Only a launch of the
# CUDA kernel counts; the twin never does.
launch_counts = counter_group("launches", ("chol_inv", "mvn_ll", "tri_inv", "mvn_ll_inv",
                                           "cholesky", "se_kernel", "se_kernel_bwd"))


def on_cpu(*ts) -> bool:
    """True where every tensor is on the CPU (the wrapper runs its twin),
    False where all are on one CUDA device (it launches its kernel); any
    other mix raises."""
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"inputs must all be on the CPU or on one CUDA device, got {devs}")
    return False


def check(name, t, shape):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def stream(t):
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


@dataclasses.dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile and link time; 0.0 when the library was already built
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


def _compile(nvcc: str, srcs: list[Path], out_dir: Path) -> tuple[list[Path], str]:
    """One nvcc process per source, all running at once; raises if any fails."""
    tag = os.getpid()
    jobs = []
    for p in srcs:
        obj = out_dir / f"{p.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(p)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [obj for _, obj, _ in jobs], "".join(log)


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
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, log = _compile(nvcc, [p for p in srcs if p.suffix == ".cu"], out_dir)
        tmp = out_dir / f".libgprf_kernels.{os.getpid()}.so"
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
        for obj in objs:
            obj.unlink()
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
