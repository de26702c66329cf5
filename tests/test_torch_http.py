"""The port's HTTP front end on the CPU: JSON and multipart stitch, EXIF,
health and stats, warmup, the grid and merge fields, and the status
mapping (400, 413, 503, 504, 500); the scenarios of tests/test_http.py that
the port supports.

Answers are held to ``imagestitching_tpu_torch.stitch`` on the same bytes
bit for bit (the same decoder and arithmetic on either path), and to the
float64 oracle within 1 uint8 step, on the JAX package's own plan of the
job.
"""

import base64
import io
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

import imagestitching_tpu_torch as itt
from imagestitching_tpu.config import StitchOptions as JaxStitchOptions
from imagestitching_tpu.core import oracle
from imagestitching_tpu.core.layout import ImageSpec, solve
from imagestitching_tpu.imgio import codec
from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
from imagestitching_tpu_torch.serve import http
from imagestitching_tpu_torch.serve.http import StitchHTTPServer

CPU = RuntimeConfig(device="cpu")
T = 10
rng = np.random.default_rng(41)


@pytest.fixture(scope="module")
def srv():
    with StitchHTTPServer(port=0, config=CPU, max_wait_s=0.005) as s:
        yield s


def _url(srv, path):
    return f"http://{srv.host}:{srv.port}{path}"


def _get_json(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=T) as r:
        return json.loads(r.read())


def _png(arr):
    return codec.encode_bytes(arr, "png")


def _post_json(srv, payload, path="/stitch"):
    req = urllib.request.Request(
        _url(srv, path), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=T)


def _status_of(srv, payload, path="/stitch"):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_json(srv, payload, path)
    return ei.value.code, json.loads(ei.value.read())


def _decode(resp):
    return np.asarray(Image.open(io.BytesIO(resp.read())))


def test_healthz_names_the_device_and_stats(srv):
    h = _get_json(srv, "/healthz")
    assert h == {"ok": True, "backend": "cpu"}
    st = _get_json(srv, "/stats")
    assert "jobs" in st["server"] and "log_tail" in st


def test_stitch_json_roundtrip(srv):
    imgs = [rng.integers(0, 256, (40, 60, 3), np.uint8),
            rng.integers(0, 256, (50, 45, 3), np.uint8)]
    blobs = [_png(a) for a in imgs]
    payload = {"images": [base64.b64encode(b).decode() for b in blobs],
               "direction": "vertical", "mode": "min", "gap": 4}
    with _post_json(srv, payload) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = _decode(r)
    opts = StitchOptions(gap=4)
    np.testing.assert_array_equal(out, itt.stitch(blobs, options=opts,
                                                  config=CPU))
    plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs],
                 JaxStitchOptions(gap=4))
    assert int(np.abs(out.astype(int)
                      - oracle.stitch(plan, imgs).astype(int)).max()) <= 1


def _multipart(blobs, boundary="xXbOuNdArYxX"):
    parts = [(f"--{boundary}\r\n"
              f'Content-Disposition: form-data; name="file{i}"; '
              f'filename="{i}.png"\r\n'
              "Content-Type: image/png\r\n\r\n").encode() + b + b"\r\n"
             for i, b in enumerate(blobs)]
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def test_stitch_multipart_png_equals_stitch(srv):
    blobs = [_png(rng.integers(0, 256, (h, w, 3), np.uint8))
             for w, h in ((64, 48), (40, 56), (50, 30))]
    body, ctype = _multipart(blobs)
    req = urllib.request.Request(
        _url(srv, "/stitch?direction=horizontal&mode=max&gap=2.5"),
        data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=T) as r:
        out = _decode(r)
    want = itt.stitch(blobs, options=StitchOptions(
        direction="horizontal", mode="max", gap=2.5), config=CPU)
    np.testing.assert_array_equal(out, want)


def test_stitch_multipart_jpeg_out(srv):
    blobs = [_png(rng.integers(0, 256, (32, 32, 3), np.uint8))] * 2
    body, ctype = _multipart(blobs)
    req = urllib.request.Request(
        _url(srv, "/stitch?direction=horizontal&format=jpg&quality=92"),
        data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=T) as r:
        assert r.headers["Content-Type"] == "image/jpeg"
        assert _decode(r).shape == (32, 64, 3)


def test_stitch_json_exif_orientation(srv):
    arr = rng.integers(0, 256, (40, 30, 3), np.uint8)
    buf = io.BytesIO()
    img = Image.fromarray(arr)
    ex = img.getexif()
    ex[274] = 6                      # 90-degree rotation: display 40x30
    img.save(buf, "JPEG", quality=95, exif=ex)
    payload = {"images": [base64.b64encode(buf.getvalue()).decode()],
               "direction": "vertical"}
    with _post_json(srv, payload) as r:
        out = _decode(r)
    assert out.shape == (30, 40, 3)  # oriented dims, not raw 40x30
    np.testing.assert_array_equal(
        out, itt.stitch([buf.getvalue()], config=CPU))


def test_stitch_json_array_background(srv):
    imgs = [rng.integers(0, 256, (20, 20, 3), np.uint8) for _ in range(2)]
    payload = {"images": [base64.b64encode(_png(a)).decode() for a in imgs],
               "background": [10, 200, 30], "gap": 4}
    with _post_json(srv, payload) as r:
        out = _decode(r)
    assert out.shape == (44, 20, 3)
    np.testing.assert_array_equal(out[21, 0], [10, 200, 30])   # gap row


def test_concurrent_mixed_requests(srv):
    """Concurrent clients with differing geometries: every answer is its own
    strip, and the stats count the jobs."""
    def one(k):
        r = np.random.default_rng(500 + k)
        imgs = [r.integers(0, 256, (20 + (k % 3) * 8, 30, 3), np.uint8)
                for _ in range(2)]
        payload = {"images": [base64.b64encode(_png(a)).decode()
                              for a in imgs],
                   "direction": "vertical", "mode": "min", "gap": k % 5}
        with _post_json(srv, payload) as resp:
            out = _decode(resp)
        plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs],
                     JaxStitchOptions(gap=k % 5))
        want = oracle.stitch(plan, imgs)
        assert out.shape == want.shape, k
        assert int(np.abs(out.astype(int) - want.astype(int)).max()) <= 1
        return True

    before = _get_json(srv, "/stats")["server"]["jobs"]
    with ThreadPoolExecutor(8) as ex:
        assert all(ex.map(one, range(8)))
    assert _get_json(srv, "/stats")["server"]["jobs"] >= before + 8


def test_bad_request_is_400(srv):
    code, body = _status_of(srv, {})
    assert code == 400 and "error" in body
    code, _ = _status_of(srv, {"images": [base64.b64encode(b"junk").decode()]})
    assert code == 400                                  # undecodable image


def test_unknown_route_is_404(srv):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(srv, "/nope"), timeout=T)
    assert ei.value.code == 404


@pytest.mark.parametrize("field", ["grid_cols", "merge_overlap"])
def test_not_yet_ported_options_are_501(srv, field):
    """The extension fields answer 200 with the extension's result: a
    2-column grid of four equal tiles is their blit mosaic (twin of
    tests/test_grid.py:181-205), and a merged pair of overlapping strips
    is the capture they were cut from (tests/test_merge_overlap.py:193-216).
    """
    if field == "grid_cols":
        imgs = [rng.integers(0, 256, (50, 40, 3), np.uint8)
                for _ in range(4)]
        want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                          np.vstack([imgs[1], imgs[3]])])
        extra = {"grid_cols": 2, "gap": 0}
    else:
        want = rng.integers(0, 256, (460, 72, 3), np.uint8)
        imgs = [want[:250], want[200:]]
        extra = {"merge_overlap": "true"}
    payload = {"images": [base64.b64encode(_png(a)).decode() for a in imgs],
               **extra}
    with _post_json(srv, payload) as r:
        assert r.status == 200
        np.testing.assert_array_equal(_decode(r), want)


def test_grid_cols_raises_not_implemented(srv):
    """``stitch_blobs`` runs a grid job itself (not through the batcher):
    the grid of two equal tiles, and no job added to the server's count."""
    options, enc = http._options_from({"grid_cols": "2", "gap": "0"})
    imgs = [rng.integers(0, 256, (20, 16, 3), np.uint8) for _ in range(2)]
    before = srv.server.stats()["jobs"]
    data, ctype = srv.stitch_blobs([_png(a) for a in imgs], options, enc)
    assert ctype == "image/png"
    np.testing.assert_array_equal(codec.decode(data)[0], np.hstack(imgs))
    assert srv.server.stats()["jobs"] == before
    assert srv.server.stats()["pending"] == 0


def test_request_size_limit_is_413():
    with StitchHTTPServer(port=0, config=CPU,
                          max_request_bytes=1000) as small:
        req = urllib.request.Request(
            f"http://{small.host}:{small.port}/stitch", data=b"x" * 2000,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=T)
        assert ei.value.code == 413


def test_overload_is_503_before_decode(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("decode ran on a rejected request")

    with StitchHTTPServer(port=0, config=CPU, max_queue=0) as tiny:
        monkeypatch.setattr(http.codec, "decode", boom)
        img = base64.b64encode(_png(
            rng.integers(0, 256, (8, 8, 3), np.uint8))).decode()
        code, _ = _status_of(tiny, {"images": [img]})
        assert code == 503


def test_internal_failure_is_500(srv, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("device exploded")

    monkeypatch.setattr(srv.server, "submit", boom)
    img = base64.b64encode(_png(
        rng.integers(0, 256, (8, 8, 3), np.uint8))).decode()
    code, body = _status_of(srv, {"images": [img]})
    assert code == 500 and "device exploded" in body["error"]


def test_status_mapping():
    import concurrent.futures as cf

    assert http._status_for(ValueError("x")) == 400
    assert http._status_for(http.BadImage("x")) == 400
    assert http._status_for(TimeoutError("slow")) == 504
    assert http._status_for(cf.TimeoutError()) == 504
    assert http._status_for(NotImplementedError("later")) == 500
    assert http._status_for(RuntimeError("x")) == 500
    assert http._status_for(MemoryError()) == 500


def test_http_warmup(srv):
    with _post_json(srv, {"shapes": [[24, 32], [20, 28]], "gap": 2,
                          "batch_sizes": [1, 3]}, "/warmup") as r:
        assert r.status == 200
        info = json.loads(r.read())
    assert info == {"engine": "auto", "batches": [1, 3],
                    "signature_cached": True}
    assert srv.server.stats()["warmups"] >= 2


@pytest.mark.parametrize("payload,word", [
    ({}, "shapes"),
    ([1, 2], "JSON object"),
    ({"shapes": [[16, 16]], "batch_sizes": 8}, "batch_sizes"),
])
def test_http_warmup_bad_requests_are_400(srv, payload, word):
    code, body = _status_of(srv, payload, "/warmup")
    assert code == 400 and word in body["error"]


def test_main_help(capsys):
    with pytest.raises(SystemExit) as ei:
        http.main(["--help"])
    assert ei.value.code == 0
    assert "--engine" in capsys.readouterr().out
