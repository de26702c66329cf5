"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) at first use.

The twin of ``pallas_resize._build_call_static`` (single-job, batched and
windowed) and of the staged-band microbenchmark's ``build``: where the JAX
package lowers a ``pl.pallas_call`` through Mosaic, the port compiles its
CUDA C++ sources with ``nvcc``, one process per source, all started
together, and links them into one shared library with a plain C interface,
loaded with ``ctypes``.  No PyTorch headers are compiled, so a build takes
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
    command: List[str]              # the link
    compiles: List[List[str]]       # one nvcc per source, run together
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
    """Compile each of ``csrc/*.cu`` into an object, every ``nvcc`` started
    at once, and link them into one shared library, unless a library with
    the same source hash is already built."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = _digest(srcs)
    out = BUILD_DIR / f"libisx_kernels_{digest}.so"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [BUILD_DIR / f"{s.stem}_{digest}.{os.getpid()}.o" for s in srcs]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    compiles = [[nvcc(), *flags, "-c", "-o", str(o), str(s)]
                for o, s in zip(objs, srcs)]
    link = [nvcc(), *NVCC_FLAGS, "-o", str(out), *map(str, objs)]
    if out.exists():
        return BuildInfo(out, link, compiles, 0.0, True, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in compiles]
        logs, failed = [], []
        for cmd, proc in zip(compiles, procs):
            try:
                _, err = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link[link.index("-o") + 1] = str(tmp)
        proc = subprocess.run(link, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    link[link.index("-o") + 1] = str(out)
    return BuildInfo(out, link, compiles, time.perf_counter() - t0, False,
                     "".join(logs))


def _bind(lib: ctypes.CDLL) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.resize_place_args_size.argtypes = []
    lib.resize_place_args_size.restype = i32
    lib.resize_place_prepare.argtypes = [p]             # PlaceArgs*
    lib.resize_place_prepare.restype = i32
    lib.resize_place_run.argtypes = [p, p, p, p]    # args, src, canvas, stream
    lib.resize_place_run.restype = i32
    lib.resize_place_window_run.argtypes = [
        p, p, i32, i32, i32,                 # args, crop, start, shift, rows
        p]                                   # stream
    lib.resize_place_window_run.restype = i32
    lib.resize_place_staged_args_size.argtypes = []
    lib.resize_place_staged_args_size.restype = i32
    lib.resize_place_staged_prepare.argtypes = [p]      # StagedArgs*
    lib.resize_place_staged_prepare.restype = i32
    lib.resize_place_staged_run.argtypes = [p, p, p]    # args, src, stream
    lib.resize_place_staged_run.restype = i32
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
