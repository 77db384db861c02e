"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together (a ``csrc/*.cuh`` is a header that sources share), and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``build/stcd_tpu_torch/`` beside the package. The library's file name carries
a hash of the sources and flags, so an edited source builds anew and an
unchanged one loads the library already there. A file lock keeps concurrent
processes from building the same library twice.

Nothing here runs at import time: the CPU tests import every module of the
package on hosts that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "stcd_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels of stcd_tpu_torch cannot be built")


def _run_all(cmds) -> None:
    """Start every command at once, wait for all, raise for the first that
    failed with its output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{output}")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and the headers they share
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libstcd_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():  # another process built it while we waited
                return so
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            nvcc = _nvcc()
            objs = {src: tmp.with_suffix(f".{src.stem}.o")
                    for src in sorted(CSRC.glob("*.cu"))}
            try:
                _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in objs.items()])
                _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj) for obj in objs.values()]]])
                os.replace(tmp, so)
            finally:
                for path in (tmp, *objs.values()):
                    path.unlink(missing_ok=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries."""
    lib = ctypes.CDLL(str(build()))
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    ll = ctypes.c_longlong
    lib.stcd_cross_attention_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f,
                                             i, u, p, u, f, i, p]
    lib.stcd_cross_attention_fwd.restype = i
    lib.stcd_cross_attention_bwd.argtypes = [p] * 11 + [i, i, i, i, i, i, i, i, i, f, i, u,
                                                        p, u, f, i, p]
    lib.stcd_cross_attention_bwd.restype = i
    lib.stcd_bn_stats_fwd.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
    lib.stcd_bn_stats_fwd.restype = i
    lib.stcd_augment_fwd.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.stcd_augment_fwd.restype = i
    lib.stcd_matmul_bf16.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, i, i, p]
    lib.stcd_matmul_bf16.restype = i
    lib.stcd_matmul_stats_rows.argtypes = [p, p, p, p, p, p, p, ll, i, i, ll, i, p]
    lib.stcd_matmul_stats_rows.restype = i
    for entry in (lib.stcd_matmul_stats, lib.stcd_matmul_stats_mma):
        entry.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, ll, i, p]
        entry.restype = i
    lib.stcd_cuda_error_string.argtypes = [i]
    lib.stcd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.stcd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
