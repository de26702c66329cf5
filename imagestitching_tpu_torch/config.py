"""Configuration of the PyTorch port.

The user-facing options and the limits -- ``StitchOptions``,
``CanvasLimits``, ``MemoryBudget``, ``DIRECTIONS``, ``MODES`` and
``SUPPORTED_TYPES`` -- are the port's own copies of
``imagestitching_tpu/config.py:15-156``, equal to them field for field
(``tests/test_torch_standalone.py``); they are part of the layout contract.
``MemoryBudget.from_device`` probed the TPU and is left behind: the port's
twin is :func:`budget_from_device`.

``RuntimeConfig`` is the port's own (twin of :159-203): it has the JAX
package's ``profile``, ``decode_window`` and ``overlap`` with their
validation, a ``device`` in place of JAX's implicit platform, and a
``mesh`` (:class:`.parallel.mesh.DeviceMesh` in place of a
``jax.sharding.Mesh``).  The JAX package's ``interpret`` (Pallas interpret
mode) has no twin.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["CanvasLimits", "DIRECTIONS", "ENGINES", "MODES", "MemoryBudget",
           "RuntimeConfig", "SUPPORTED_TYPES", "StitchOptions",
           "budget_from_device"]

# Directions and modes mirror the reference's user-facing settings
# (index.js:17-20, the settings modal index.js:791-885).
DIRECTIONS = ("vertical", "horizontal")
MODES = ("min", "max", "original")

# Supported input formats (reference whitelist at index.js:4; HEIC/HEIF are
# handled by a transcode fallback, canvas.js:255-267).
SUPPORTED_TYPES = ("jpg", "jpeg", "png", "webp", "bmp", "gif")


@dataclasses.dataclass(frozen=True)
class CanvasLimits:
    """Output-canvas size governor.

    TPU-native analog of the reference's device canvas caps
    (``index.js:1323-1357``): a max side length, a max total pixel count and a
    supersampling ceiling.  On TPU these bound HBM usage of the output buffer
    rather than a GPU texture limit; they are configurable rather than probed.
    """

    max_side: int = 65536
    max_pixels: int = 1 << 30          # ~1 Gpx default; effectively "unlimited"
    max_supersample: float = 2.2       # reference: 2.2 iOS / 2.6 android (index.js:1363)

    @staticmethod
    def reference_ios() -> "CanvasLimits":
        # index.js:1325-1329 — side 12288, pixel cap 16384*1400
        return CanvasLimits(max_side=12288, max_pixels=16384 * 1400,
                            max_supersample=2.2)

    @staticmethod
    def reference_android(max_side: int = 4096) -> "CanvasLimits":
        # index.js:1325,1330-1332 — side 4096, pixel cap side*min(side,8192)
        return CanvasLimits(max_side=max_side,
                            max_pixels=max_side * min(max_side, 8192),
                            max_supersample=2.6)


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """HBM budget governor (replaces reference pixel caps + big-task mode).

    ``hbm_bytes`` bounds the device working set of one stitch job: output
    canvas + staged source(s) + intermediates.  The tiler
    (:mod:`imagestitching_tpu_torch.runtime.tiler`) picks a streaming/banding plan so
    peak HBM stays under this bound — the TPU answer to the reference's
    ``scaleDown`` clamping (index.js:1323-1357) and big-task serial flushes
    (index.js:1560-1571): never shrink the user's output, just tile it.
    """

    hbm_bytes: int = 2 * (1 << 30)     # BASELINE config 4: 2 GB
    host_cache_pixels: int = 64 * 1_000_000  # bitmap-cache analog (index.js:6-7)
    host_cache_entries: int = 6              # (index.js:8-9)
    # Disk prepared-artifact store (the saveFile + storage-quota governor
    # analog, index.js:629-676): decode results persisted across processes,
    # LRU-evicted to this byte quota.  None disables persistence.
    artifact_dir: Optional[str] = None
    artifact_quota_bytes: int = 512 << 20


@dataclasses.dataclass(frozen=True)
class StitchOptions:
    """User-facing stitch parameters (reference: direction/mode/gap,
    index.js:17-20,824-832; gap clamped to [0, 20] at index.js:824-832)."""

    direction: str = "vertical"
    mode: str = "min"
    gap: float = 0.0
    # The reference supersamples by default for phone-display sharpness
    # (index.js:1360-1386); as a framework default that 2.2x output-size
    # surprise is wrong, so it is opt-in here (parity mode: pass True).
    supersample: bool = False
    background: Tuple[int, int, int] = (255, 255, 255)  # white fill (index.js:1423-1424)
    filter: str = "bilinear"           # "bilinear" | "triangle" | "box" | "lanczos3"
    max_images: Optional[int] = 9      # MAX_IMAGES (index.js:311); None = unlimited
    # Auto-overlap merge (framework extension — the reference concatenates
    # verbatim and users hand-trim overlapping screenshots): detect the
    # duplicated strip between consecutive images along the stitch axis and
    # trim it before layout (ops/overlap.py).  merge_threshold is the max
    # mean-abs-diff (uint8 levels) for an overlap to count as a duplicate
    # (2.0 tolerates JPEG recompression; 0.0 = exact only).
    merge_overlap: bool = False
    merge_threshold: float = 2.0

    def validate(self) -> "StitchOptions":
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, got {self.direction!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.gap < 0:
            raise ValueError(f"gap must be >= 0, got {self.gap}")
        if self.filter not in ("bilinear", "triangle", "box", "lanczos3"):
            raise ValueError(f"unknown filter {self.filter!r}")
        if self.merge_threshold < 0:
            raise ValueError(f"merge_threshold must be >= 0, "
                             f"got {self.merge_threshold}")
        # Normalize background to a hashable (int, int, int): it flows into
        # plan.signature(), which every compiled-program cache hashes — a
        # list/ndarray background must not blow up there (and must compare
        # equal to its tuple twin so equal jobs share one compile).
        try:
            bg = tuple(int(v) for v in self.background)
        except (TypeError, ValueError):
            raise ValueError(f"background must be an RGB triple, "
                             f"got {self.background!r}")
        if len(bg) != 3 or any(not (0 <= v <= 255) for v in bg):
            raise ValueError(f"background must be three ints in [0, 255], "
                             f"got {self.background!r}")
        if bg != self.background:
            return dataclasses.replace(self, background=bg)
        return self

#: ``auto`` -- the resize-and-place engine: the CUDA kernel on a CUDA
#: device, its plain PyTorch version on the CPU; ``cuda`` -- the same, but
#: only on a CUDA device; ``torch`` -- the plain whole-job engine
#: (``ops.torch_compose``), the cross-check, on either device; ``oracle``
#: -- the float64 NumPy oracle on the host.
ENGINES = ("auto", "cuda", "torch", "oracle")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine and runtime knobs of the port."""

    engine: str = "auto"
    device: str = "cuda"               # torch device: cuda, cuda:N or cpu
    # Default canvas caps for entry points without an explicit ``limits=``.
    limits: CanvasLimits = dataclasses.field(default_factory=CanvasLimits)
    budget: MemoryBudget = dataclasses.field(default_factory=MemoryBudget)
    # torch.profiler over each job; the trace goes under
    # $IMAGESTITCH_TRACE_DIR (default: <tempdir>/imagestitching_trace)
    profile: bool = False
    decode_threads: int = 8            # host codec pool
    # Per-image decode watchdog; None disables it.
    decode_timeout_s: Optional[float] = 30.0
    # Ack-window backpressure of the host-blit paths: the most decoded
    # sources in flight or held unconsumed at once; None -> auto (twice the
    # decode workers, floor 4; runtime/decoding.default_window).
    decode_window: Optional[int] = None
    # decode || upload || compute: "auto" for big jobs (7 or more images or
    # 25 MB of input, the reference's big-task thresholds), "always" or
    # "never".
    overlap: str = "auto"
    # Optional parallel.mesh.DeviceMesh: a "space" axis > 1 shards a single
    # job's canvas row bands across its devices (parallel.sharding); the
    # server's use_mesh takes its "jobs" axis for batches.
    mesh: Optional[object] = None

    def validate(self) -> "RuntimeConfig":
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"one of {ENGINES}")
        kind = str(self.device).split(":", 1)[0]
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda[:N] or cpu, "
                             f"got {self.device!r}")
        if self.engine == "cuda" and kind != "cuda":
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs a CUDA device")
        if self.overlap not in ("auto", "always", "never"):
            raise ValueError(f"overlap must be auto/always/never, "
                             f"got {self.overlap!r}")
        if self.decode_timeout_s is not None and self.decode_timeout_s <= 0:
            raise ValueError("decode_timeout_s must be positive or None, "
                             f"got {self.decode_timeout_s}")
        if self.decode_window is not None and self.decode_window < 1:
            raise ValueError("decode_window must be >= 1 or None, "
                             f"got {self.decode_window}")
        if self.mesh is not None:
            from .parallel.mesh import DeviceMesh   # torch: only with a mesh

            if not isinstance(self.mesh, DeviceMesh):
                raise ValueError("mesh must be a parallel.mesh.DeviceMesh "
                                 "(parallel.mesh.make_mesh), got "
                                 f"{type(self.mesh).__name__}")
        return self


def budget_from_device(device: str = "cuda") -> MemoryBudget:
    """A ``MemoryBudget`` of 0.6 of the card's total memory (twin of
    ``MemoryBudget.from_device``'s default), from
    ``torch.cuda.mem_get_info``.  A CPU device has no card to probe and gets
    the default budget, as ``from_device`` does where it finds no device."""
    import torch

    from .runtime.pipeline import resolve_device

    device = resolve_device(device)     # a missing card raises RuntimeError
    if device.type == "cpu":
        return MemoryBudget()
    _, total = torch.cuda.mem_get_info(device)
    return MemoryBudget(hbm_bytes=int(total * 0.6))
