"""High-level stitch API of the port: arrays/files in -> array/file out.

Port of ``imagestitching_tpu/api.py:192-233`` (``stitch_arrays``), :284-354
(``stitch``) and :357-432 (``stitch_to_file``).  The host helpers --
``prepare`` (parallel decode with failure isolation), ``_load_one``,
``_as_uint8`` and ``_unify_channels`` -- are the JAX package's own, shared by
import: they touch no device.

``stitch`` takes the ``prepare`` -> ``stitch_arrays`` flow for every job.
The JAX package's overlapped decode/compute scheduler gives the same bits
and arrives with a later slice, as do the streaming export
(``stitch_to_file(stream=True | "auto")``) and ``merge_overlap``.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Union

import numpy as np

from imagestitching_tpu.api import (ImageInput, ProgressFn, _as_uint8,
                                    _noop_progress, _unify_channels, prepare)
from imagestitching_tpu.core.layout import ImageSpec, solve
from imagestitching_tpu.imgio import codec
from imagestitching_tpu.runtime.logger import get_logger

from .config import CanvasLimits, RuntimeConfig, StitchOptions


def stitch_arrays(images: Sequence[np.ndarray],
                  specs: Optional[Sequence[ImageSpec]] = None,
                  options: Optional[StitchOptions] = None,
                  config: Optional[RuntimeConfig] = None,
                  limits: Optional[CanvasLimits] = None,
                  progress: ProgressFn = _noop_progress,
                  return_metrics: bool = False,
                  keep_on_device: bool = False):
    """Stitch already-decoded raw arrays (uint8 HWC) into one strip.

    With ``return_metrics=True`` returns ``(array, StitchMetrics)``.
    ``keep_on_device=True`` returns the canvas as a tensor on
    ``config.device`` instead of reading it back, when the strategy holds
    it there (resident, streamed); the banded strategy composites on the
    host and returns numpy either way.
    """
    options = (options or StitchOptions()).validate()
    config = (config or RuntimeConfig()).validate()
    if options.merge_overlap:
        raise NotImplementedError(
            "merge_overlap arrives with the port's extensions slice")
    if limits is None:
        limits = config.limits          # explicit arg overrides the config
    images = _unify_channels([_as_uint8(a) for a in images])
    if specs is None:
        specs = [ImageSpec(a.shape[1], a.shape[0]) for a in images]
    log = get_logger()
    plan = solve(specs, options, limits)
    log.event("stitch.plan", canvas=(plan.canvas_w, plan.canvas_h),
              n=len(images), mode=plan.mode, direction=plan.direction,
              supersample=plan.supersample, scale_down=plan.scale_down)
    from .runtime import pipeline
    out, metrics = pipeline.run(plan, images, config, progress,
                                keep_on_device=keep_on_device)
    log.event("stitch.done", shape=tuple(out.shape))
    if return_metrics:
        return out, metrics
    return out


def stitch(items: Sequence[ImageInput],
           direction: str = "vertical", mode: str = "min", gap: float = 0.0,
           options: Optional[StitchOptions] = None,
           config: Optional[RuntimeConfig] = None,
           limits: Optional[CanvasLimits] = None,
           on_error: str = "raise",
           progress: ProgressFn = _noop_progress,
           return_metrics: bool = False,
           keep_on_device: bool = False):
    """Stitch image files/bytes/arrays (or ``(array, orientation)`` tuples)
    into one strip; returns uint8 HWC.  ``options`` overrides the
    individual direction/mode/gap arguments."""
    if options is None:
        options = StitchOptions(direction=direction, mode=mode, gap=gap)
    config = (config or RuntimeConfig()).validate()
    t0 = time.perf_counter()
    images, specs, failures = prepare(items, config, on_error, progress)
    prepare_s = time.perf_counter() - t0
    if not images:
        if failures:
            raise RuntimeError(
                f"all {len(failures)} images failed to prepare; "
                f"first: {failures[0][1]!r}")
        raise ValueError("no images to stitch")
    out, metrics = stitch_arrays(images, specs, options, config, limits,
                                 progress, return_metrics=True,
                                 keep_on_device=keep_on_device)
    metrics.prepare_s = prepare_s
    metrics.total_s += prepare_s
    return (out, metrics) if return_metrics else out


def stitch_to_file(items: Sequence[ImageInput],
                   out_path: Union[str, os.PathLike],
                   quality: int = 95, png_compression: int = 6,
                   stream: Union[bool, str] = False,
                   return_metrics: bool = False, **kwargs):
    """Stitch and write the result (format from the extension; PNG default)
    through the shared codec: readback, then ``codec.encode``.

    ``stream=True`` / ``"auto"`` (the JAX package's streaming export) raise
    ``NotImplementedError`` until the port's export slice lands.
    """
    if stream is not False:
        if stream in (True, "auto"):
            raise NotImplementedError(
                "streaming export arrives with the port's export slice; "
                "pass stream=False")
        raise ValueError(f"stream must be True/False/'auto', got {stream!r}")
    if "keep_on_device" in kwargs:
        raise TypeError("keep_on_device is managed by stitch_to_file; "
                        "use stitch()/stitch_arrays() for a device canvas")
    out, metrics = stitch(items, return_metrics=True, **kwargs)
    t0 = time.perf_counter()
    path = codec.encode(out_path, out, quality=quality,
                        png_compression=png_compression)
    metrics.encode_s = time.perf_counter() - t0
    metrics.export_s = metrics.readback_s + metrics.encode_s
    metrics.total_s += metrics.encode_s
    return (path, metrics) if return_metrics else path
