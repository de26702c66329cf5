"""ctypes bindings to the native host codec (native/codec.cpp).

The port's own copy of ``imagestitching_tpu/imgio/native.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

Built on demand with ``make`` (g++, libjpeg, libpng, zlib — all baked into
the image) from the repo's ``native/codec.cpp`` into the port's git-ignored
``_build/codec/``; nothing is written under ``native/``.  Where that build
fails, the prebuilt ``native/build/libisxcodec.so`` is loaded as it is, as
the original does.  ctypes releases the GIL for the call duration, so the
prepare pool's decodes run truly in parallel.  Falls back transparently to
Pillow when the toolchain or libraries are missing (see imgio.codec).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build", "codec")
_SO_PATH = os.path.join(_BUILD_DIR, "libisxcodec.so")
# the tracked prebuilt library, read only: loaded when the build fails
_PREBUILT = os.path.join(_NATIVE_DIR, "build", "libisxcodec.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={_BUILD_DIR}"],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("IMAGESTITCH_NATIVE", "1") == "0":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        # always run make: it is a no-op when fresh and rebuilds a stale
        # .so after codec.cpp changes (first call per process only)
        so_path = _SO_PATH if _build() else next(
            (p for p in (_SO_PATH, _PREBUILT) if os.path.exists(p)), None)
        if so_path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(so_path)
            _register_symbols(lib)
        except OSError:
            _build_failed = True
            return None
        except AttributeError:
            # stale .so predating a required symbol AND make failed (else
            # the rebuild above would have refreshed it): degrade to the
            # Pillow path rather than poisoning every caller (ADVICE r2)
            _build_failed = True
            return None
        _lib = lib
        return _lib


def _register_symbols(lib: ctypes.CDLL) -> None:
    lib.isx_last_error.restype = ctypes.c_char_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.isx_decode_jpeg.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.isx_decode_png.argtypes = [
        u8p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.isx_encode_jpeg.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.isx_encode_png.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.isx_encode_png_mt.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.isx_free.argtypes = [ctypes.c_void_p]
    try:        # older .so builds predate the libdeflate fast path
        lib.isx_png_fast_available.restype = ctypes.c_int
    except AttributeError:
        pass
    try:        # ...or the webp decoder; both are optional capabilities
        lib.isx_webp_available.restype = ctypes.c_int
        lib.isx_decode_webp.argtypes = [
            u8p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    except AttributeError:
        pass
    for name in ("isx_decode_bmp", "isx_decode_gif"):
        try:    # ...or the bmp/gif decoders (stale .so tolerance)
            getattr(lib, name).argtypes = [
                u8p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        except AttributeError:
            pass
    for fmt in ("png", "jpeg"):
        getattr(lib, f"isx_{fmt}_stream_open").restype = ctypes.c_void_p
        getattr(lib, f"isx_{fmt}_stream_open").argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        getattr(lib, f"isx_{fmt}_stream_write").argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int]
        getattr(lib, f"isx_{fmt}_stream_close").argtypes = [
            ctypes.c_void_p]


def available() -> bool:
    return get_lib() is not None


def _as_u8p(data: bytes):
    return ctypes.cast(ctypes.create_string_buffer(data, len(data)),
                       ctypes.POINTER(ctypes.c_uint8))


def _take(lib, ptr, nbytes: int) -> np.ndarray:
    # np.ctypeslib.as_array on a bare pointer is pathologically slow for
    # large buffers; cast to a sized array and memcpy via frombuffer.
    sized = ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)).contents
    arr = np.frombuffer(sized, dtype=np.uint8).copy()
    lib.isx_free(ptr)
    return arr


def decode_jpeg(data: bytes, scale_denom: int = 1) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.isx_decode_jpeg(_as_u8p(data), len(data), scale_denom,
                             ctypes.byref(out), ctypes.byref(w),
                             ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"jpeg decode: {lib.isx_last_error().decode()}")
    flat = _take(lib, out, w.value * h.value * 3)
    return flat.reshape(h.value, w.value, 3)


def decode_png(data: bytes) -> Optional[np.ndarray]:
    return _decode_simple("isx_decode_png", data)


def webp_available() -> bool:
    """True when the loaded codec was built against libwebp."""
    lib = get_lib()
    try:
        return lib is not None and bool(lib.isx_webp_available())
    except AttributeError:      # stale .so predating the webp decoder
        return False


def decode_webp(data: bytes) -> Optional[np.ndarray]:
    """Decode a static WEBP to white-composited RGB8; None when the codec
    lacks libwebp; raises on animated/corrupt input (the caller's Pillow
    ladder handles those)."""
    if not webp_available():    # gate on the build capability, not just the
        return None             # symbol: a stub without libwebp exports it
    return _decode_simple("isx_decode_webp", data)


def _decode_simple(fn_name: str, data: bytes) -> Optional[np.ndarray]:
    """Shared driver for the (data) -> RGB8 decoders (png/webp/bmp/gif)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, fn_name):
        return None             # stale .so predating the decoder
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(_as_u8p(data), len(data), ctypes.byref(out),
                               ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(
            f"{fn_name[len('isx_decode_'):]} decode: "
            f"{lib.isx_last_error().decode()}")
    flat = _take(lib, out, w.value * h.value * 3)
    return flat.reshape(h.value, w.value, 3)


def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    """Decode an uncompressed 8/24/32-bit BMP to RGB8; None when the codec
    is unavailable; raises on RLE/V4+/exotic variants (the caller's Pillow
    ladder handles those)."""
    return _decode_simple("isx_decode_bmp", data)


def decode_gif(data: bytes) -> Optional[np.ndarray]:
    """Decode a GIF's first frame to white-composited RGB8 (matches
    Pillow's no-seek open for animated files); None when the codec is
    unavailable; raises on partial-first-frame/corrupt input."""
    return _decode_simple("isx_decode_gif", data)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    rc = lib.isx_encode_jpeg(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, quality,
        ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"jpeg encode: {lib.isx_last_error().decode()}")
    return bytes(_take(lib, out, n.value))


def png_fast_available() -> bool:
    """True when the loaded codec has the libdeflate fast PNG path enabled."""
    lib = get_lib()
    try:
        return lib is not None and bool(lib.isx_png_fast_available())
    except AttributeError:
        return False


def encode_png(rgb: np.ndarray, compression: int = 6,
               threads: Optional[int] = None) -> Optional[bytes]:
    """PNG-encode RGB8.

    Prefers the single-shot libdeflate path (SIMD deflate, ~10-20x zlib
    single-core) when available; otherwise multi-threaded pigz-style
    parallel deflate strips whenever the image is big enough to amortize
    thread startup.  Pass ``threads`` explicitly to force the MT encoder.
    """
    lib = get_lib()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if threads is None:
        threads = 1 if png_fast_available() else (
            min(os.cpu_count() or 1, 16) if w * h >= 1 << 20 else 1)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    if threads > 1:
        rc = lib.isx_encode_png_mt(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
            compression, threads, ctypes.byref(out), ctypes.byref(n))
    else:
        rc = lib.isx_encode_png(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
            compression, ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"png encode: {lib.isx_last_error().decode()}")
    return bytes(_take(lib, out, n.value))


class _StreamWriter:
    """Band-incremental file writer (native, GIL-free per band).

    Feed row bands top-to-bottom with :meth:`write`; :meth:`close` finalizes
    the file (and fails if the row count doesn't match).  As a context
    manager it closes on success and aborts (freeing the native handle,
    leaving a partial file for the caller to unlink) on exception.
    """

    _fmt = ""          # "png" | "jpeg" (subclasses)

    def __init__(self, path: str, width: int, height: int, param: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native codec unavailable")
        if width <= 0 or height <= 0:
            raise ValueError(f"bad canvas size {width}x{height}")
        self._lib = lib
        self.width, self.height = int(width), int(height)
        self.rows_written = 0
        handle = getattr(lib, f"isx_{self._fmt}_stream_open")(
            os.fspath(path).encode(), self.width, self.height, int(param))
        if not handle:
            raise ValueError(
                f"{self._fmt} stream open: {lib.isx_last_error().decode()}")
        self._handle = handle

    def write(self, band: np.ndarray) -> None:
        if self._handle is None:
            raise ValueError("writer is closed")
        band = np.ascontiguousarray(band, np.uint8)
        if band.ndim != 3 or band.shape[1] != self.width \
                or band.shape[2] != 3:
            raise ValueError(f"band shape {band.shape} != "
                             f"(n, {self.width}, 3)")
        n = band.shape[0]
        if self.rows_written + n > self.height:
            raise ValueError("more rows than the declared height")
        rc = getattr(self._lib, f"isx_{self._fmt}_stream_write")(
            self._handle, band.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), n)
        if rc != 0:
            err = self._lib.isx_last_error().decode()
            self.abort()
            raise ValueError(f"{self._fmt} stream write: {err}")
        self.rows_written += n

    def close(self) -> None:
        if self._handle is None:
            return
        handle, self._handle = self._handle, None
        rc = getattr(self._lib, f"isx_{self._fmt}_stream_close")(handle)
        if rc != 0:
            raise ValueError(f"{self._fmt} stream close: "
                             f"{self._lib.isx_last_error().decode()}")

    def abort(self) -> None:
        """Free the native handle without requiring a complete image."""
        if self._handle is None:
            return
        handle, self._handle = self._handle, None
        # rc ignored: a partial file is expected on the abort path
        getattr(self._lib, f"isx_{self._fmt}_stream_close")(handle)

    def __enter__(self) -> "_StreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


class PngStreamWriter(_StreamWriter):
    _fmt = "png"

    def __init__(self, path: str, width: int, height: int,
                 compression: int = 6):
        super().__init__(path, width, height, compression)


class JpegStreamWriter(_StreamWriter):
    """Scanline-incremental JPEG twin: bytes identical to encode_jpeg at
    equal quality."""

    _fmt = "jpeg"

    def __init__(self, path: str, width: int, height: int,
                 quality: int = 95):
        super().__init__(path, width, height, quality)
