"""Native HEIC/HEIF codec via ctypes bindings to the system libheif.

The port's own copy of ``imagestitching_tpu/imgio/heif.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

The reference can only handle HEIC by re-encoding it to JPEG through the
platform (``tryTranscodeIfNeeded``, utils/canvas.js:255-267, at quality 100 —
a lossy extra generation).  Binding libheif directly decodes HEIC losslessly
into the pipeline (and can encode it), no transcode generation needed.

libheif applies EXIF/irot/imir transformations during decode by default, so
decoded pixels are display-oriented (orientation = 1).
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

# --- libheif C enums (stable public API) -----------------------------------
_COLORSPACE_RGB = 1
_CHROMA_INTERLEAVED_RGB = 10
_CHROMA_INTERLEAVED_RGBA = 11
_CHANNEL_INTERLEAVED = 10
_COMPRESSION_HEVC = 1

_HEIC_BRANDS = (b"heic", b"heix", b"hevc", b"hevx", b"heim", b"heis",
                b"hevm", b"hevs", b"mif1", b"msf1")


class _HeifError(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("subcode", ctypes.c_int),
                ("message", ctypes.c_char_p)]


_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL("libheif.so.1")
        except OSError:
            _load_failed = True
            return None
        p = ctypes.c_void_p
        lib.heif_context_alloc.restype = p
        lib.heif_context_free.argtypes = [p]
        lib.heif_context_read_from_memory_without_copy.restype = _HeifError
        lib.heif_context_read_from_memory_without_copy.argtypes = [
            p, ctypes.c_void_p, ctypes.c_size_t, p]
        lib.heif_context_get_primary_image_handle.restype = _HeifError
        lib.heif_context_get_primary_image_handle.argtypes = [
            p, ctypes.POINTER(p)]
        lib.heif_image_handle_get_width.argtypes = [p]
        lib.heif_image_handle_get_height.argtypes = [p]
        lib.heif_image_handle_has_alpha_channel.argtypes = [p]
        lib.heif_image_handle_release.argtypes = [p]
        lib.heif_decode_image.restype = _HeifError
        lib.heif_decode_image.argtypes = [p, ctypes.POINTER(p),
                                          ctypes.c_int, ctypes.c_int, p]
        lib.heif_image_get_plane_readonly.restype = \
            ctypes.POINTER(ctypes.c_uint8)
        lib.heif_image_get_plane_readonly.argtypes = [
            p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.heif_image_release.argtypes = [p]
        # encoder (for fixtures / HEIC output)
        lib.heif_context_get_encoder_for_format.restype = _HeifError
        lib.heif_context_get_encoder_for_format.argtypes = [
            p, ctypes.c_int, ctypes.POINTER(p)]
        lib.heif_encoder_set_lossy_quality.restype = _HeifError
        lib.heif_encoder_set_lossy_quality.argtypes = [p, ctypes.c_int]
        lib.heif_encoder_release.argtypes = [p]
        lib.heif_image_create.restype = _HeifError
        lib.heif_image_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(p)]
        lib.heif_image_add_plane.restype = _HeifError
        lib.heif_image_add_plane.argtypes = [p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_int]
        lib.heif_image_get_plane.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.heif_image_get_plane.argtypes = [p, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
        lib.heif_context_encode_image.restype = _HeifError
        lib.heif_context_encode_image.argtypes = [p, p, p, p,
                                                  ctypes.POINTER(p)]
        lib.heif_context_write_to_file.restype = _HeifError
        lib.heif_context_write_to_file.argtypes = [p, ctypes.c_char_p]
        _lib = lib
        return _lib


def available() -> bool:
    return (os.environ.get("IMAGESTITCH_HEIF", "1") != "0"
            and _load() is not None)


def is_heif(data: bytes) -> bool:
    """Sniff the ISOBMFF ftyp box for HEIC/HEIF brands."""
    return (len(data) > 12 and data[4:8] == b"ftyp"
            and data[8:12] in _HEIC_BRANDS)


_ERROR_NAMES = {1: "input does not exist", 2: "invalid input",
                3: "unsupported filetype", 4: "unsupported feature",
                5: "usage error", 6: "memory allocation error",
                7: "decoder plugin error", 8: "encoder plugin error",
                9: "encoding error", 10: "color profile error"}


def _check(err: _HeifError, what: str) -> None:
    if err.code != 0:
        msg = (err.message or b"").decode(errors="replace").strip()
        if not msg:
            msg = _ERROR_NAMES.get(err.code, "error")
        raise ValueError(f"heif {what}: {msg} (code {err.code})")


def probe(data: bytes) -> Tuple[int, int]:
    """(width, height) of the primary image (display-oriented)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libheif unavailable")
    ctx = lib.heif_context_alloc()
    try:
        buf = ctypes.create_string_buffer(data, len(data))
        _check(lib.heif_context_read_from_memory_without_copy(
            ctx, buf, len(data), None), "read")
        handle = ctypes.c_void_p()
        _check(lib.heif_context_get_primary_image_handle(
            ctx, ctypes.byref(handle)), "primary handle")
        try:
            w = lib.heif_image_handle_get_width(handle)
            h = lib.heif_image_handle_get_height(handle)
            return int(w), int(h)
        finally:
            lib.heif_image_handle_release(handle)
    finally:
        lib.heif_context_free(ctx)


def decode(data: bytes) -> np.ndarray:
    """Decode HEIC bytes to RGB uint8 HWC (alpha composited on white).

    Transformations (rotation/mirror) are applied by libheif, so the result
    is display-oriented; callers should treat orientation as 1.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libheif unavailable")
    ctx = lib.heif_context_alloc()
    try:
        buf = ctypes.create_string_buffer(data, len(data))
        _check(lib.heif_context_read_from_memory_without_copy(
            ctx, buf, len(data), None), "read")
        handle = ctypes.c_void_p()
        _check(lib.heif_context_get_primary_image_handle(
            ctx, ctypes.byref(handle)), "primary handle")
        try:
            w = int(lib.heif_image_handle_get_width(handle))
            h = int(lib.heif_image_handle_get_height(handle))
            # decompression-bomb guard, BEFORE HEVC decode allocates: same
            # Pillow DecompressionBombError threshold as every decoder in
            # native/codec.cpp (a few-KB file can declare huge dimensions)
            if w * h > 178_956_970:
                raise ValueError(
                    f"heif: {w}x{h} = {w * h} px exceeds the decompression-"
                    "bomb limit (178956970)")
            has_alpha = bool(lib.heif_image_handle_has_alpha_channel(handle))
            chroma = (_CHROMA_INTERLEAVED_RGBA if has_alpha
                      else _CHROMA_INTERLEAVED_RGB)
            img = ctypes.c_void_p()
            _check(lib.heif_decode_image(handle, ctypes.byref(img),
                                         _COLORSPACE_RGB, chroma, None),
                   "decode")
            try:
                stride = ctypes.c_int()
                plane = lib.heif_image_get_plane_readonly(
                    img, _CHANNEL_INTERLEAVED, ctypes.byref(stride))
                if not plane:
                    raise ValueError("heif: no interleaved plane")
                nch = 4 if has_alpha else 3
                rowbytes = stride.value
                sized = ctypes.cast(
                    plane,
                    ctypes.POINTER(ctypes.c_uint8 * (rowbytes * h))).contents
                arr = np.frombuffer(sized, np.uint8).reshape(h, rowbytes)
                arr = arr[:, : w * nch].reshape(h, w, nch).copy()
            finally:
                lib.heif_image_release(img)
        finally:
            lib.heif_image_handle_release(handle)
    finally:
        lib.heif_context_free(ctx)
    if arr.shape[2] == 4:
        a = arr[:, :, 3:4].astype(np.float64) / 255.0
        rgb = arr[:, :, :3].astype(np.float64) * a + 255.0 * (1.0 - a)
        arr = np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)
    return arr


def encode_to_file(path: str, rgb: np.ndarray, quality: int = 90) -> str:
    """Encode RGB uint8 HWC to a HEIC file (HEVC via x265)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libheif unavailable")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    ctx = lib.heif_context_alloc()
    img = ctypes.c_void_p()
    enc = ctypes.c_void_p()
    try:
        _check(lib.heif_image_create(w, h, _COLORSPACE_RGB,
                                     _CHROMA_INTERLEAVED_RGB,
                                     ctypes.byref(img)), "image_create")
        _check(lib.heif_image_add_plane(img, _CHANNEL_INTERLEAVED, w, h, 8),
               "add_plane")
        stride = ctypes.c_int()
        plane = lib.heif_image_get_plane(img, _CHANNEL_INTERLEAVED,
                                         ctypes.byref(stride))
        rowbytes = stride.value
        dst = ctypes.cast(plane,
                          ctypes.POINTER(ctypes.c_uint8 * (rowbytes * h)))
        view = np.frombuffer(dst.contents, np.uint8).reshape(h, rowbytes)
        view[:, : w * 3] = rgb.reshape(h, w * 3)
        _check(lib.heif_context_get_encoder_for_format(
            ctx, _COMPRESSION_HEVC, ctypes.byref(enc)), "get_encoder")
        _check(lib.heif_encoder_set_lossy_quality(enc, quality), "quality")
        out_handle = ctypes.c_void_p()
        _check(lib.heif_context_encode_image(ctx, img, enc, None,
                                             ctypes.byref(out_handle)),
               "encode")
        lib.heif_image_handle_release(out_handle)
        _check(lib.heif_context_write_to_file(ctx, path.encode()), "write")
        return path
    finally:
        if enc:
            lib.heif_encoder_release(enc)
        if img:
            lib.heif_image_release(img)
        lib.heif_context_free(ctx)
