"""imagestitching_tpu_torch -- the stitcher on PyTorch and CUDA (Hopper).

The port of :mod:`imagestitching_tpu` (JAX on a TPU), which stays beside it
as the reference.  The port imports nothing of it.  The host layers that
never touch a device -- the layout solver, the grid planner and the f64
taps (``core/``), the NumPy oracle, the codec (``imgio/``), the decode pool,
the caches, the logger and the memory tiler (``runtime/``) -- are the port's
own copies, equal to the originals in what they compute;
``tests/test_torch_standalone.py`` holds each one equal to its original,
because they are the parity contract.  Everything that touched JAX is
ported: the resize-and-place kernel, single-job, batched and windowed, is
hand-written CUDA C++ (``csrc/resize_place.cu``), built with ``nvcc`` at
first use.  Batched serving is ``StitchServer`` and its HTTP front end
``StitchHTTPServer``; files in, file out is ``stitch_to_file`` (the
overlapped decode/upload/draw scheduler and the streaming export) and
``python -m imagestitching_tpu_torch.cli``; the extensions are the grid
collage ``stitch_grid``, the preview ``make_preview`` (one launch of the
kernel) and ``StitchOptions.merge_overlap`` (``ops/overlap.py``).

Port of ``imagestitching_tpu/__init__.py``: the same names, the option
types and the layout solver eagerly, the entry points lazily, so
``import imagestitching_tpu_torch`` loads neither JAX nor torch.
"""

from .config import (CanvasLimits, MemoryBudget, RuntimeConfig, StitchOptions,
                     DIRECTIONS, MODES, SUPPORTED_TYPES)
from .core import ImageSpec, LayoutPlan, Placement, solve

__version__ = "0.1.0"

__all__ = [
    "CanvasLimits", "MemoryBudget", "RuntimeConfig", "StitchOptions",
    "DIRECTIONS", "MODES", "SUPPORTED_TYPES",
    "ImageSpec", "LayoutPlan", "Placement", "solve",
    "stitch", "stitch_arrays", "stitch_to_file", "stitch_grid",
]


def __getattr__(name):  # lazy: keep `import imagestitching_tpu_torch` torch-free
    if name in ("stitch", "stitch_arrays", "stitch_to_file", "stitch_grid",
                "make_preview", "preview_size", "prepare"):
        from . import api
        return getattr(api, name)
    if name == "StitchServer":
        from .serve.server import StitchServer
        return StitchServer
    if name == "StitchHTTPServer":
        from .serve.http import StitchHTTPServer
        return StitchHTTPServer
    if name == "ArtifactStore":
        from .runtime.artifacts import ArtifactStore
        return ArtifactStore
    if name == "StitchMetrics":
        from .runtime.pipeline import StitchMetrics
        return StitchMetrics
    raise AttributeError(name)
