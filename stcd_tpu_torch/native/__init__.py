"""Host image IO in C++: JPEG/PNG decode and batch collate without the
interpreter lock (counterpart of stcd_tpu/native).

``stcd_io.cpp`` decodes with libjpeg/libpng straight into caller-owned numpy
buffers and fans a whole batch across a std::thread pool, so the loader's
decode threads (data/loader.py) run in parallel. Its pixels equal PIL's
``convert("RGB")``; no device is involved.

The shared library is built with ``g++`` at first use, never at import, into
``build/stcd_tpu_torch/`` beside the package (not beside its source), under a
name that carries a hash of the source and the flags; it is compiled under a
temporary name and published by an atomic rename, so concurrent processes
never load a half-written file. Every entry point degrades to PIL:

- toolchain or libjpeg/libpng missing -> ``load()`` returns None, one warning
- a format other than JPEG/PNG, or a decode error -> that file goes to PIL
- ``STCD_NO_NATIVE=1`` -> disabled outright
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from stcd_tpu_torch.ops._build import BUILD_DIR

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "stcd_io.cpp"
CXX_FLAGS = ["-O2", "-fPIC", "-shared"]
LIBS = ["-ljpeg", "-lpng"]
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    """Where the library for the current source and flags lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libstcd_io_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native IO build failed (%s); using PIL decode", e)
        return False
    try:
        if res.returncode != 0:
            logger.warning("native IO build failed:\n%s\nusing PIL decode",
                           res.stderr.strip()[-2000:])
            return False
        os.replace(tmp, so)
        return True
    finally:
        tmp.unlink(missing_ok=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.stcd_image_dims.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.stcd_image_dims.restype = ctypes.c_int
    lib.stcd_decode_rgb.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
    lib.stcd_decode_rgb.restype = ctypes.c_int
    lib.stcd_decode_rgb_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p]
    lib.stcd_decode_rgb_batch.restype = ctypes.c_int
    lib.stcd_io_abi_version.argtypes = []
    lib.stcd_io_abi_version.restype = ctypes.c_int
    if lib.stcd_io_abi_version() != ABI_VERSION:
        raise OSError("stcd_io ABI version mismatch")
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, building it on first call; None when the native
    path is unavailable (the failure is remembered: one warning, then
    silence)."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("STCD_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            _load_failed = True
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(so)))
        except (OSError, AttributeError) as e:
            logger.warning("native IO unavailable (%s); using PIL decode", e)
            _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def image_dims(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) of a JPEG/PNG, or None (unsupported or unavailable)."""
    lib = load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.stcd_image_dims(os.fsencode(path), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_rgb(path: str) -> Optional[np.ndarray]:
    """Decode one image to (H, W, 3) uint8 RGB; None means the caller reads
    it with PIL (a format other than JPEG/PNG, a decode error, or no native
    library)."""
    lib = load()
    if lib is None:
        return None
    dims = image_dims(path)
    if dims is None:
        return None
    h, w = dims
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.stcd_decode_rgb(os.fsencode(path),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out if rc == 0 else None


def decode_rgb_batch(paths: Sequence[str], height: int, width: int,
                     num_threads: int = 4) -> Tuple[Optional[np.ndarray], List[bool]]:
    """Decode and collate ``paths`` into one (N, H, W, 3) uint8 array on the
    native thread pool. Returns (batch, ok), ok[i] flagging the files that
    decoded; failed rows are zero-filled for the caller to read with PIL.
    (None, [False] * n) when the native library is unavailable."""
    n = len(paths)
    lib = load()
    if lib is None:
        return None, [False] * n
    out = np.zeros((n, height, width, 3), np.uint8)
    status = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.stcd_decode_rgb_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, num_threads, status)
    ok = [status[i] == 0 for i in range(n)]
    if failures:
        for i, good in enumerate(ok):
            if not good:
                out[i] = 0
    return out, ok
