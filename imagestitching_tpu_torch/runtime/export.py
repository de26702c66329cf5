"""Streaming canvas export: band readback overlapped with the native encode.

Port of ``imagestitching_tpu/runtime/export.py``.  A canvas can be 100+ MP,
and fetching it whole before a single-threaded PNG/JPEG encode leaves the
link idle while the encoder runs and the encoder idle while the link runs.
:func:`stream_to_png` / :func:`stream_to_jpeg` cut the canvas into row
bands and feed them to the native incremental writers
(:class:`..imgio.native.PngStreamWriter` / ``JpegStreamWriter``) while the
next bands are still being read back.  Peak host memory is a few bands.

The canvas is a host array (bands are encoded straight out of it) or a
``torch.Tensor`` (:func:`_stream_device`).  For a tensor on a CUDA device
the readback is the card's: band copies into a ring of pinned host buffers
on a stream of their own, enqueued ahead of the encoder, so the copy engine
runs while the encoder runs.  A CPU tensor takes the same code without
pinning or streams.

:func:`stream_blit_to_file` is the pure-blit export: every drawn placement
is an identity copy, so bands are assembled on the host straight from the
decoded sources and no device is touched.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .logger import get_logger

ProgressFn = Callable[[str, float], None]

# Target ~24 MB read back per band: big enough to amortize the per-copy
# overhead, small enough that a ring of a few bands stays cheap in host RAM.
_BAND_BYTES = 24 << 20


def _noop(phase: str, fraction: float) -> None:
    del phase, fraction


def band_rows_for(width: int, channels: int = 3,
                  target_bytes: int = _BAND_BYTES) -> int:
    rows = max(64, target_bytes // max(1, width * channels))
    return int(rows)


def stream_to_png(canvas, path: str, png_compression: int = 6,
                  band_rows: Optional[int] = None,
                  progress: ProgressFn = _noop) -> dict:
    """Write ``canvas`` (uint8 HWC, 3 channels) to ``path`` as PNG, banded.

    ``canvas`` may be a host numpy array (bands are encoded straight out of
    it) or a ``torch.Tensor`` on any device (bands are read back ahead of the
    encoder).  Returns a phase dict:
    ``{"readback_s", "encode_s", "wall_s", "overlapped": bool}`` --
    ``encode_s`` is the encoder's busy time, ``readback_s`` the time a band
    copy was in flight, ``wall_s`` the elapsed export time (< their sum when
    the overlap engages).

    Raises if the native codec is unavailable -- callers fall back to the
    monolithic :func:`..imgio.codec.encode` path (see ``api.stitch_to_file``).
    On any error the partial output file is removed.
    """
    return _stream_to_file(canvas, path, "png", png_compression, band_rows,
                           progress)


def stream_to_jpeg(canvas, path: str, quality: int = 95,
                   band_rows: Optional[int] = None,
                   progress: ProgressFn = _noop) -> dict:
    """JPEG twin of :func:`stream_to_png` (scanline-incremental libjpeg;
    bytes identical to the monolithic encoder at equal quality)."""
    return _stream_to_file(canvas, path, "jpeg", quality, band_rows,
                           progress)


def _stream_to_file(canvas, path: str, fmt: str, param: int,
                    band_rows: Optional[int],
                    progress: ProgressFn) -> dict:
    from ..imgio import native

    h, w = int(canvas.shape[0]), int(canvas.shape[1])
    channels = int(canvas.shape[2]) if canvas.ndim == 3 else 1
    if channels != 3:
        raise ValueError("streaming export requires a 3-channel canvas")
    band = min(h, band_rows or band_rows_for(w))
    t_wall = time.perf_counter()
    on_device = isinstance(canvas, torch.Tensor)
    phases = {"readback_s": 0.0, "encode_s": 0.0, "overlapped": on_device}

    cls = (native.PngStreamWriter if fmt == "png"
           else native.JpegStreamWriter)
    writer = cls(path, w, h, param)
    try:
        if not on_device:
            arr = np.asarray(canvas)
            for r in range(0, h, band):
                t0 = time.perf_counter()
                writer.write(arr[r: r + band])
                phases["encode_s"] += time.perf_counter() - t0
                progress("export", min(1.0, (r + band) / h))
            writer.close()
        else:
            _stream_device(canvas, writer, h, w, channels, band, phases,
                           progress)
    except BaseException:
        writer.abort()
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    phases["wall_s"] = time.perf_counter() - t_wall
    get_logger().event(
        f"export.stream_{fmt}", canvas=(w, h), band_rows=band,
        wall_s=round(phases["wall_s"], 3),
        readback_s=round(phases["readback_s"], 3),
        encode_s=round(phases["encode_s"], 3))
    return phases


def _stream_device(canvas: torch.Tensor, writer, h: int, w: int,
                   channels: int, band: int, phases: dict,
                   progress: ProgressFn, depth: int = 3) -> None:
    """Read ``canvas`` back in ``band``-row bands into a ring of ``depth``
    host buffers and hand them to ``writer`` top to bottom.

    On a CUDA device the buffers are pinned and each band's copy is
    enqueued, non-blocking, on a device-to-host stream that first waits for
    the work already queued on the canvas's stream (the kernels that drew
    it).  The host enqueues ``depth`` bands ahead, then for each band waits
    for its copy's event, writes it (the writer copies synchronously) and
    enqueues the band ``depth`` further into the freed buffer: the copy
    engine works while the encoder does, with no producer thread and every
    CUDA call on this thread.  ``readback_s`` is the time a band copy was in
    flight, from CUDA events around each copy; the copies run one at a time
    on one stream, so their sum is the union of the in-flight intervals and
    counts neither encoder stalls nor overlap twice.  On the CPU the copies
    are synchronous and timed by the host clock.
    """
    if canvas.ndim != 3 or tuple(canvas.shape) != (h, w, channels):
        raise ValueError(f"canvas {tuple(canvas.shape)} is not "
                         f"({h}, {w}, {channels})")
    canvas = canvas.contiguous()
    dev = canvas.device
    cuda = dev.type == "cuda"
    n_bands = -(-h // band)
    depth = max(1, min(depth, n_bands))
    bufs = [torch.empty((band, w, channels), dtype=torch.uint8,
                        pin_memory=cuda) for _ in range(depth)]
    d2h = torch.cuda.Stream(dev) if cuda else None
    # per band in flight: (start event, end event), None on the CPU
    events = {}

    def enqueue(bi: int) -> None:
        r = bi * band
        dst = bufs[bi % depth][:min(band, h - r)]
        if d2h is None:
            t0 = time.perf_counter()
            dst.copy_(canvas[r:r + dst.shape[0]])
            phases["readback_s"] += time.perf_counter() - t0
            events[bi] = None
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(d2h):
            start.record(d2h)
            dst.copy_(canvas[r:r + dst.shape[0]], non_blocking=True)
            end.record(d2h)
        events[bi] = (start, end)

    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        if d2h is not None:
            # the bands are read only after the kernels that drew them
            d2h.wait_stream(torch.cuda.current_stream(dev))
        try:
            for bi in range(depth):
                enqueue(bi)
            for bi in range(n_bands):
                ev = events.pop(bi)
                if ev is not None:
                    ev[1].synchronize()
                    phases["readback_s"] += ev[0].elapsed_time(ev[1]) / 1e3
                t0 = time.perf_counter()
                writer.write(bufs[bi % depth][:min(band, h - bi * band)]
                             .numpy())
                phases["encode_s"] += time.perf_counter() - t0
                if bi + depth < n_bands:     # the writer is done with it
                    enqueue(bi + depth)
                progress("export", min(1.0, (bi + 1) / n_bands))
        finally:
            # no copy may still write a buffer or read the canvas once this
            # returns or raises
            if d2h is not None:
                d2h.synchronize()
    writer.close()


def stream_blit_to_file(plan, loaders, path: str, fmt: str, param: int,
                        copies: dict, decode_threads: int,
                        decode_timeout_s: Optional[float] = None,
                        progress: ProgressFn = _noop,
                        window: Optional[int] = None) -> dict:
    """Pure-blit export: decode pool -> host band assembly -> native encode.

    When every drawn placement is an identity copy (equal-size concat --
    the reference's own hot path degenerates to drawImage blits there too,
    pages/index/index.js:1423-1431), the canvas never needs to exist on
    *either* side: bands are assembled straight from the decoded sources
    and fed to the streaming encoder, skipping the upload, device
    compositing and the readback entirely.  ``copies`` is
    :func:`..core.geometry.plan_copy_offsets` for ``plan``.

    Decode runs on the watchdogged pool under an **ack window**: sources
    are *submitted in band-consumption order* and each decoded source holds
    a window slot until its rows are fully written, so peak decoded
    residency is O(window) regardless of job size.  Returns
    ``{"decode_s", "encode_s", "wall_s", "overlapped": True}`` where
    ``decode_s`` is the decode time *exposed* in the band loop (decodes
    that land while earlier bands encode are genuinely overlapped).

    On any error the partial output file is removed and the error re-raised
    (decode failures abort the job -- by stitch time geometry is committed,
    the reference aborts there too, index.js:1507-1509).
    """
    from ..core import geometry
    from ..imgio import native
    from . import decoding

    H, W = int(plan.canvas_h), int(plan.canvas_w)
    t_wall = time.perf_counter()
    phases = {"decode_s": 0.0, "encode_s": 0.0, "overlapped": True}
    band = min(H, band_rows_for(W))
    if window is None:
        window = decoding.default_window(decode_threads, len(loaders))

    # Submission order = the order bands will first need each source (first
    # intersecting band, stable by plan order within a band; never-drawn
    # sources last).  With FIFO dispatch this makes the windowed pool
    # deadlock-free -- PROVIDED the window covers every source a single band
    # consumes concurrently, so the effective window is floored at the
    # plan's max per-band source count.  A horizontal strip needs every
    # source in every band, so its residency is inherently O(n).
    def _is_drawn(p) -> bool:
        return (p.row_span[1] > p.row_span[0]
                and p.col_span[1] > p.col_span[0])

    drawn = {p.index for p in plan.placements if _is_drawn(p)}
    n_bands = -(-H // band)
    delta = [0] * (n_bands + 1)
    for p in plan.placements:
        if p.index in drawn:
            delta[p.row_span[0] // band] += 1
            delta[(min(p.row_span[1], H) - 1) // band + 1] -= 1
    peak_band_sources, acc = 1, 0
    for d in delta[:-1]:
        acc += d
        peak_band_sources = max(peak_band_sources, acc)
    window = max(window, peak_band_sources)
    order = [p.index for p in sorted(
        (p for p in plan.placements if _is_drawn(p)),
        key=lambda p: p.row_span[0] // band)]
    order += [p.index for p in plan.placements if p.index not in drawn]

    cls = (native.PngStreamWriter if fmt == "png"
           else native.JpegStreamWriter)
    writer = cls(path, W, H, param)
    gen = decoding.iter_decoded([loaders[i] for i in order], decode_threads,
                                decode_timeout_s, window=window,
                                indices=order)
    ready: dict = {}
    oriented: dict = {}

    def _get_oriented(p) -> np.ndarray:
        img = oriented.get(p.index)
        if img is not None:
            return img
        t0 = time.perf_counter()
        while p.index not in ready:
            i, raw, err = next(gen)    # original image index (indices=)
            if err is not None:
                raise err
            if i not in drawn:
                gen.ack()          # no band will consume it; free the slot
                continue
            ready[i] = np.asarray(raw)
        phases["decode_s"] += time.perf_counter() - t0
        raw = geometry.normalize_rgb(ready.pop(p.index))
        if raw is None or raw.shape[:2] != (p.raw_h, p.raw_w):
            raise ValueError(
                f"image {p.index}: decoded "
                f"{None if raw is None else raw.shape} but header said "
                f"{p.raw_w}x{p.raw_h}x3")
        img = geometry.orient_array(raw, p.orientation)
        oriented[p.index] = img
        return img

    bg = np.asarray(plan.background[:3], np.uint8)
    buf = np.empty((band, W, 3), np.uint8)
    try:
        for r0 in range(0, H, band):
            r1 = min(H, r0 + band)
            b = buf[: r1 - r0]
            geometry.fill_background(b, bg)
            for p in plan.placements:
                pr0, pr1 = p.row_span
                pc0, pc1 = p.col_span
                if (pr1 <= pr0 or pc1 <= pc0
                        or pr1 <= r0 or pr0 >= r1):
                    continue
                img = _get_oriented(p)
                sr0, sc0 = copies[p.index]
                a0, a1 = max(pr0, r0), min(pr1, r1)
                b[a0 - r0: a1 - r0, pc0:pc1] = img[
                    sr0 + (a0 - pr0): sr0 + (a1 - pr0),
                    sc0: sc0 + (pc1 - pc0)]
            t0 = time.perf_counter()
            writer.write(b)
            phases["encode_s"] += time.perf_counter() - t0
            progress("export", r1 / H)
            for p in plan.placements:   # release fully-written sources
                if (p.row_span[1] <= r1
                        and oriented.pop(p.index, None) is not None):
                    gen.ack()           # slot freed -> next decode submits
        # drain the pool before finalizing: images whose placements drew
        # nothing (zero-area spans) were still submitted -- a corrupt or
        # hung one must fail the job exactly as the device path's prepare
        # would, not silently succeed
        for _, _, err in gen:
            gen.ack()
            if err is not None:
                raise err
        writer.close()
    except BaseException:
        writer.abort()
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    finally:
        gen.close()
    phases["wall_s"] = time.perf_counter() - t_wall
    get_logger().event(
        f"export.stream_blit_{fmt}", canvas=(W, H), band_rows=band,
        n=len(copies), window=window, wall_s=round(phases["wall_s"], 3),
        decode_s=round(phases["decode_s"], 3),
        encode_s=round(phases["encode_s"], 3))
    return phases
