"""HTTP front end for the batch stitch server (standard library only).

Port of ``imagestitching_tpu/serve/http.py``.  Concurrent clients feed the
dynamic batcher of :class:`.server.StitchServer`; requests that arrive within
``max_wait_s`` of each other with one geometry share one batched run.

* ``POST /stitch``  -- images in request order, either
  ``multipart/form-data`` file parts or JSON ``{"images": ["<base64>", ..]}``;
  stitch options via query string or JSON fields (``direction``, ``mode``,
  ``gap``, ``filter``, ``background="R,G,B"``, ``format=png|jpg``,
  ``quality``, ``png_level``).  Responds with the encoded strip.
  ``merge_overlap`` and ``grid_cols`` answer 501 until the port's
  extensions slice lands.
* ``POST /warmup``  -- run one zero batch per size for an expected job
  geometry (JSON ``{"shapes": [[h, w], ...], "batch_sizes": [1, 8], ...}``
  plus the option fields of ``/stitch``).
* ``GET /healthz``  -- liveness, the torch device and the card's name.
* ``GET /stats``    -- batcher counters plus the logger ring tail.

Decode runs on the HTTP worker threads (the shared native codec releases
the GIL); the server's worker thread owns the device.

    python -m imagestitching_tpu_torch.serve.http --port 8080
"""

from __future__ import annotations

import base64
import json
import threading
from email.message import Message
from email.parser import BytesParser
from email.policy import HTTP as _HTTP_POLICY
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import torch

from imagestitching_tpu.imgio import codec, native
from imagestitching_tpu.runtime.logger import get_logger

from ..config import RuntimeConfig, StitchOptions
from .server import ServerOverloaded, StitchServer


class BadImage(ValueError):
    """A request image failed to decode: the client's bytes, their 400."""


def _status_for(e: Exception) -> int:
    """Map a request failure to an HTTP status: client errors (bad options,
    undecodable images) 400, a job past the result deadline 504, a feature
    the port has not reached yet 501, anything else (a device or kernel
    failure) 500."""
    if isinstance(e, ValueError):
        return 400
    if isinstance(e, TimeoutError):      # concurrent.futures alias too
        return 504
    if isinstance(e, NotImplementedError):
        return 501
    return 500


def _parse_multipart(content_type: str, body: bytes) -> List[bytes]:
    """File parts, in order, from a multipart/form-data body."""
    head = (f"Content-Type: {content_type}\r\n"
            "MIME-Version: 1.0\r\n\r\n").encode()
    msg: Message = BytesParser(policy=_HTTP_POLICY).parsebytes(head + body)
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data")
    return [part.get_payload(decode=True)
            for part in msg.iter_parts()
            if part.get_payload(decode=True)]


def _options_from(params: dict) -> Tuple[StitchOptions, dict]:
    def one(key, default=None):
        v = params.get(key)
        # parse_qs wraps each value in a single-element str list; JSON
        # arrays (e.g. "background": [250, 250, 250]) pass through intact
        if isinstance(v, list) and len(v) == 1 and isinstance(v[0], str):
            v = v[0]
        return default if v is None else v

    bg = one("background", "255,255,255")
    if isinstance(bg, str):
        bg = [int(x) for x in bg.split(",")]
    bg = tuple(int(x) for x in bg)
    options = StitchOptions(
        direction=one("direction", "vertical"),
        mode=one("mode", "min"),
        gap=float(one("gap", 0.0)),
        filter=one("filter", "bilinear"),
        background=tuple(bg),
        supersample=str(one("supersample", "")).lower() in ("1", "true"),
        merge_overlap=str(one("merge_overlap", "")).lower()
        in ("1", "true"),
        merge_threshold=float(one("merge_threshold", 2.0)),
    ).validate()
    out = {
        "format": str(one("format", "png")).lower(),
        "quality": int(one("quality", 95)),
        "png_level": int(one("png_level", 6)),
        "grid_cols": (int(one("grid_cols")) if one("grid_cols") is not None
                      else None),
        "grid_order": str(one("grid_order", "balance")),
        "valign": str(one("valign", "top")),
    }
    if out["format"] not in ("png", "jpg", "jpeg"):
        raise ValueError(f"unknown format {out['format']!r}")
    if out["grid_cols"] is not None and out["grid_cols"] < 1:
        raise ValueError(f"grid_cols must be >= 1, got {out['grid_cols']}")
    return options, out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "imagestitching-tpu-torch"

    # quiet by default; the structured logger is the observability surface
    def log_message(self, fmt, *args):  # noqa: D102
        del fmt, args

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj, headers=()) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json",
                   headers)

    def do_GET(self):  # noqa: N802
        path = urlparse(self.path).path
        app = self.server.app          # type: ignore[attr-defined]
        if path == "/healthz":
            self._send_json(200, {"ok": True, "backend": app.backend()})
        elif path == "/stats":
            self._send_json(200, {
                "server": app.server.stats(),
                "log_tail": get_logger().ring()[-20:],
            })
        else:
            self._send_json(404, {"error": f"no route {path}"})

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        if url.path not in ("/stitch", "/warmup"):
            self._send_json(404, {"error": f"no route {url.path}"})
            return
        app = self.server.app          # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > app.max_request_bytes:
                # the unread body would corrupt a keep-alive connection
                # (parsed as the next request line): drop the connection
                self.close_connection = True
                self._send_json(413, {
                    "error": f"request {length} B exceeds the "
                             f"{app.max_request_bytes} B limit"})
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            params = {k: v for k, v in parse_qs(url.query).items()}
            if url.path == "/warmup":
                payload = json.loads(body or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("warmup body must be a JSON object")
                params = {**payload, **params}
                options, _ = _options_from(params)
                shapes = payload.get("shapes") or []
                if not shapes:
                    raise ValueError("no shapes in warmup request")
                info = app.server.warmup(
                    shapes, options,
                    orientations=payload.get("orientations"),
                    batch_sizes=payload.get("batch_sizes", (1,)))
                self._send_json(200, info)
                return
            if ctype.startswith("multipart/form-data"):
                blobs = _parse_multipart(ctype, body)
            else:
                payload = json.loads(body or b"{}")
                blobs = [base64.b64decode(b)
                         for b in payload.get("images", [])]
                params = {**payload, **params}
            if not blobs:
                raise ValueError("no images in request")
            options, enc = _options_from(params)
            data, ctype_out = app.stitch_blobs(blobs, options, enc)
            self._send(200, data, ctype_out)
        except ServerOverloaded as e:
            # overload, not a client error: 503 + Retry-After so
            # well-behaved clients retry
            get_logger().event("http.overloaded", error=repr(e))
            self._send_json(503, {"error": str(e)}, (("Retry-After", "1"),))
        except Exception as e:  # noqa: BLE001 — request isolation boundary
            code = _status_for(e)
            get_logger().event("http.request_fail", error=repr(e),
                               status=code)
            self._send_json(code, {"error": str(e)})


class StitchHTTPServer:
    """HTTP wrapper around :class:`StitchServer`.

    >>> cfg = RuntimeConfig(device="cuda")
    >>> with StitchHTTPServer(port=0, config=cfg) as srv:
    ...     print(srv.port)   # serve until closed
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080,
                 server: Optional[StitchServer] = None,
                 max_request_bytes: int = 256 << 20, **server_kw):
        self.max_request_bytes = max_request_bytes
        self.server = server or StitchServer(**server_kw)
        self._own_server = server is None
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.app = self         # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="stitch-http")
        self._thread.start()
        get_logger().event("http.listen", host=self.host, port=self.port)

    def backend(self) -> str:
        """The server's torch device, with the card's name on CUDA."""
        device = self.server.device
        if device.type == "cuda":
            return f"{device} ({torch.cuda.get_device_name(device)})"
        return str(device)

    def stitch_blobs(self, blobs: List[bytes], options: StitchOptions,
                     enc: dict) -> Tuple[bytes, str]:
        """Decode request images, run one batched job, encode the strip."""
        if enc.get("grid_cols"):
            raise NotImplementedError(
                "grid_cols (the grid collage, api.stitch_grid) arrives with "
                "the port's extensions slice")
        # overload pre-check before paying per-request decode work (the
        # authoritative slot-reserving check still happens at submission)
        self.server.ensure_capacity()
        try:
            decoded = [codec.decode(b) for b in blobs]
        except Exception as e:   # noqa: BLE001 — any failure here is the
            raise BadImage(f"image decode failed: {e}") from e  # client's
        images = [d[0] for d in decoded]
        orientations = [d[1] for d in decoded]   # EXIF applied on device
        out = self.server.submit(images, options,
                                 orientations=orientations).result(
                                     timeout=300)
        if enc["format"] in ("jpg", "jpeg"):
            data = codec.encode_bytes(out, "jpeg", quality=enc["quality"])
            return data, "image/jpeg"
        png = (native.encode_png(out, compression=enc["png_level"])
               if native.available() and out.shape[2] == 3 else None)
        if png is None:
            png = codec.encode_bytes(out, "png")
        return png, "image/png"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._own_server:
            self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def main(argv=None) -> int:
    """``python -m imagestitching_tpu_torch.serve.http [--port N] ...``"""
    import argparse

    p = argparse.ArgumentParser(prog="imagestitching-tpu-torch-serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N, or cpu (the kernel's "
                        "plain PyTorch version)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--engine", default="auto",
                   choices=("auto", "cuda", "torch"),
                   help="auto: the batched CUDA kernel on a CUDA device, its "
                        "plain version on the CPU; cuda: the kernel only; "
                        "torch: the plain whole-job engine")
    args = p.parse_args(argv)
    srv = StitchHTTPServer(args.host, args.port,
                           max_batch=args.max_batch,
                           max_wait_s=args.max_wait_ms / 1000.0,
                           engine=args.engine,
                           config=RuntimeConfig(device=args.device))
    print(f"serving on http://{srv.host}:{srv.port} with {srv.backend()}  "
          f"(POST /stitch, POST /warmup, GET /healthz, GET /stats)",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
