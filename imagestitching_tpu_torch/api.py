"""High-level stitch API of the port: arrays/files in -> array/file out.

Port of ``imagestitching_tpu/api.py:192-233`` (``stitch_arrays``), :284-354
(``stitch``) and :357-432 (``stitch_to_file``).  The host helpers --
``prepare`` (parallel decode with failure isolation), ``_load_one``,
``_decode_with_retry``, ``_flatten_alpha``, ``_as_uint8`` and
``_unify_channels`` -- are the port's own copies of :25-189, equal to them
in what they compute; a ``torch.Tensor`` input is read back with
``.cpu().numpy()`` where the original took a JAX array.

``stitch`` takes the ``prepare`` -> ``stitch_arrays`` flow for every job.
The JAX package's overlapped decode/compute scheduler gives the same bits
and arrives with a later slice, as do the streaming export
(``stitch_to_file(stream=True | "auto")``) and ``merge_overlap``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CanvasLimits, RuntimeConfig, StitchOptions
from .core import oracle as _oracle
from .core.layout import ImageSpec, solve
from .imgio import codec
from .runtime import decoding
from .runtime.logger import get_logger

ArrayLike = np.ndarray
ImageInput = Union[str, os.PathLike, bytes, ArrayLike, torch.Tensor,
                   Tuple[ArrayLike, int]]  # (array, exif_orientation)

ProgressFn = Callable[[str, float], None]   # (phase, fraction 0..1)


def _noop_progress(phase: str, fraction: float) -> None:
    del phase, fraction


def _load_one(item: ImageInput,
              config: Optional[RuntimeConfig] = None) -> Tuple[np.ndarray, int]:
    """Normalize one input to (raw uint8 HWC array, orientation)."""
    if isinstance(item, tuple):
        arr, orientation = item
        return _as_uint8(arr), int(orientation)
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return _as_uint8(item), 1
    if isinstance(item, (str, os.PathLike)):
        from .runtime.cache import get_cache
        budget = config.budget if config else None
        cache = get_cache(budget.host_cache_pixels if budget else 64_000_000,
                          budget.host_cache_entries if budget else 6)
        key = cache.file_key(os.fspath(item))
        if key is not None:
            hit = cache.get(key)
            if hit is not None:
                return hit
        store = akey = None
        if budget is not None and budget.artifact_dir:
            from .runtime.artifacts import get_store
            store = get_store(budget.artifact_dir,
                              budget.artifact_quota_bytes)
            akey = store.key_for(os.fspath(item))
            hit = store.get(akey) if akey else None
            if hit is not None:
                if key is not None:
                    cache.put(key, *hit)
                return hit
        path = codec.transcode_if_needed(item)
        arr, orientation = _decode_with_retry(path)
        if key is not None:
            cache.put(key, arr, orientation)
        if store is not None and akey is not None:
            store.put(akey, arr, orientation)
        return arr, orientation
    if isinstance(item, bytes):
        return _decode_with_retry(item)
    raise TypeError(f"unsupported image input {type(item)!r}")


def _decode_with_retry(src) -> Tuple[np.ndarray, int]:
    """Decode with the stitch-time second-chance ladder.

    The reference retries a failed load via transcode *inside the stitch
    loop* (index.js:1464-1509) — a decode error on a known extension gets one
    more, lossier, attempt before the job aborts.  Here the second chance is
    a truncated-tolerant salvage decode (:func:`codec.salvage_decode`).
    """
    try:
        return codec.decode(src)
    except Exception as e:
        get_logger().once("decode.salvage_attempt", error=repr(e))
        get_logger().event("decode.salvage", error=repr(e))
        return codec.salvage_decode(src)


def _flatten_alpha(arr: np.ndarray) -> np.ndarray:
    """Composite a straight-alpha uint8 HWC array (C in {2, 4}) onto white.

    Same formula and half-up rounding as the decode ladder
    (codec._img_to_rgb): the same pixels must stitch identically whether
    they arrive as an RGBA array or as encoded RGBA bytes."""
    a = arr[:, :, -1:].astype(np.float32) / 255.0
    color = arr[:, :, :-1].astype(np.float32) * a + 255.0 * (1.0 - a)
    return np.clip(np.floor(color + 0.5), 0, 255).astype(np.uint8)


def _as_uint8(arr: np.ndarray) -> np.ndarray:
    if isinstance(arr, torch.Tensor):     # read back from any device
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected HWC image, got shape {arr.shape}")
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating):
            arr = _oracle.to_uint8(arr)
        else:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.shape[2] in (2, 4):       # LA / RGBA: flatten like the decoder
        arr = _flatten_alpha(arr)
    if arr.shape[2] not in (1, 3):
        raise ValueError(
            f"expected 1/3-channel (or 2/4 with alpha) HWC image, got "
            f"{arr.shape[2]} channels")
    return arr


def _unify_channels(images: List[np.ndarray]) -> List[np.ndarray]:
    """Promote grayscale to RGB when one job mixes 1- and 3-channel images
    (a gray array next to a decoded RGB file is a normal mix, and one
    compiled program serves the whole job, so the channel count must be
    uniform).  All-gray jobs stay single-channel."""
    cs = {a.shape[2] for a in images}
    if len(cs) <= 1:
        return list(images)
    return [np.repeat(a, 3, axis=2) if a.shape[2] == 1 else a
            for a in images]


def prepare(items: Sequence[ImageInput], config: RuntimeConfig,
            on_error: str = "raise",
            progress: ProgressFn = _noop_progress,
            ) -> Tuple[List[np.ndarray], List[ImageSpec], List[Tuple[int, Exception]]]:
    """Parallel decode + normalize with per-image failure isolation.

    The reference prepares strictly serially to avoid OOM
    (index.js:1125-1157); on a host with a real allocator we decode on a
    thread pool instead.  ``on_error``:

    * ``"raise"`` — first failure aborts the job (reference stitch-phase
      behavior, index.js:1507-1509);
    * ``"skip"``  — drop failed images and stitch the rest (reference
      prepare-phase behavior, index.js:1133-1149).
    """
    if on_error not in ("raise", "skip"):
        raise ValueError("on_error must be 'raise' or 'skip'")
    log = get_logger()
    images: List[Optional[np.ndarray]] = [None] * len(items)
    orientations: List[int] = [1] * len(items)
    failures: List[Tuple[int, Exception]] = []
    done = 0
    jobs = [(lambda it=it: _load_one(it, config)) for it in items]
    pool = decoding.iter_decoded(jobs, config.decode_threads,
                                 config.decode_timeout_s)
    try:
        for i, value, err in pool:
            if err is not None:
                if not isinstance(err, Exception):
                    raise err     # KeyboardInterrupt etc. — never skippable
                log.event("prepare.fail", index=i, error=repr(err))
                if on_error == "raise":
                    raise err
                failures.append((i, err))
            else:
                images[i], orientations[i] = value
            done += 1
            progress("prepare", done / max(1, len(items)))
    finally:
        # the on_error="raise" path must cancel the pool promptly: abandoned
        # (its generator frame forms a self-cycle only gc collects), the
        # daemon workers would keep decoding every queued image meanwhile —
        # same class as the _stitch_blit_overlapped ADVICE r3 fix
        pool.close()

    kept_images: List[np.ndarray] = []
    specs: List[ImageSpec] = []
    for img, o in zip(images, orientations):
        if img is None:
            continue
        kept_images.append(img)
        specs.append(ImageSpec(raw_w=img.shape[1], raw_h=img.shape[0],
                               orientation=o))
    return kept_images, specs, failures


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
    through the codec: readback, then ``codec.encode``.

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
