"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) at first use.

The twin of ``pallas_resize._build_call_static`` (single-job, batched and
windowed): where the JAX package lowers a ``pl.pallas_call`` through Mosaic,
the port compiles its CUDA C++ sources with ``nvcc`` into a shared library
with a plain C interface and
loads it with ``ctypes``.  No PyTorch headers are compiled, so a build takes
seconds.  The library lands in ``imagestitching_tpu_torch/_build/`` under a
name keyed on a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module on hosts
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What one build (or cache hit) did."""

    path: Path
    command: List[str]
    seconds: float
    cached: bool
    log: str          # nvcc's stderr (ptxas register and spill report)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.  Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "imagestitching_tpu_torch/csrc at first use on a CUDA host")
    return found


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into one shared library, unless a library with
    the same source hash is already built."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libisx_kernels_{_digest(srcs)}.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, srcs)]
    if out.exists():
        return BuildInfo(out, cmd, 0.0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd[cmd.index("-o") + 1] = str(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half
    cmd[cmd.index("-o") + 1] = str(out)
    return BuildInfo(out, cmd, seconds, False, proc.stderr)


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.resize_place_launch.argtypes = [
        p, i64, i64, i32, i32,               # src, H, W, C, orientation
        p, p, i32, i32,                      # ri0, rw, n_rows, k_rows
        p, p, i32, i32,                      # ci0, cw, n_cols, k_cols
        p, i64, i64, i64, i64,               # canvas, H, W, r0, c0
        p]                                   # stream
    lib.resize_place_launch.restype = i32
    lib.resize_place_batch_launch.argtypes = [
        p, i32, i64,                         # src, batch, src job stride
        i64, i64, i32, i32,                  # H, W, C, orientation
        p, p, i32, i32,                      # ri0, rw, n_rows, k_rows
        p, p, i32, i32,                      # ci0, cw, n_cols, k_cols
        p, i64,                              # canvas, canvas job stride
        i64, i64, i64, i64,                  # canvas H, W, r0, c0
        p]                                   # stream
    lib.resize_place_batch_launch.restype = i32
    lib.resize_place_window_launch.argtypes = [
        p, i64, i64, i32,                    # crop, crop rows, width, C
        p, p, i32, i32, i32,                 # ri0, rw, shift, rows, K
        p, p, i32, i32,                      # ci0, cw, n_cols, k_cols
        p, i64,                              # region, region rows
        p]                                   # stream
    lib.resize_place_window_launch.restype = i32
    lib.resize_place_error_string.argtypes = [i32]
    lib.resize_place_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this process."""
    global _lib, _info
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            _bind(lib)
            _info, _lib = info, lib
    return _lib


def last_build() -> Optional[BuildInfo]:
    """The build that :func:`load` ran or found, or None before it ran."""
    return _info
