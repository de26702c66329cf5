"""imagestitching_tpu_torch -- the stitcher on PyTorch and CUDA (Hopper).

The port of :mod:`imagestitching_tpu` (JAX on a TPU), which stays beside it
as the reference.  The host layers that never touch a device -- the layout
solver and its f64 taps, the NumPy oracle, the codec, the decode pool and
the memory tiler -- are the JAX package's own, shared by import, because
they are the parity contract.  Everything that touched JAX is ported: the
resize-and-place kernel, single-job and batched, is hand-written CUDA C++
(``csrc/resize_place.cu``), built with ``nvcc`` at first use.  Batched
serving is ``StitchServer`` and its HTTP front end ``StitchHTTPServer``.

Port of ``imagestitching_tpu/__init__.py:30-47``: the entry points load
lazily, so ``import imagestitching_tpu_torch`` loads neither JAX nor CUDA.
"""

from .config import (CanvasLimits, MemoryBudget, RuntimeConfig,
                     StitchOptions)

__version__ = "0.1.0"

__all__ = [
    "CanvasLimits", "MemoryBudget", "RuntimeConfig", "StitchHTTPServer",
    "StitchMetrics", "StitchOptions", "StitchServer", "stitch",
    "stitch_arrays", "stitch_to_file",
]


def __getattr__(name):  # lazy: keep the import free of torch and CUDA
    if name in ("stitch", "stitch_arrays", "stitch_to_file"):
        from . import api
        return getattr(api, name)
    if name == "StitchServer":
        from .serve.server import StitchServer
        return StitchServer
    if name == "StitchHTTPServer":
        from .serve.http import StitchHTTPServer
        return StitchHTTPServer
    if name == "StitchMetrics":
        from .runtime.pipeline import StitchMetrics
        return StitchMetrics
    raise AttributeError(name)
