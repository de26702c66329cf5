"""The port's batch stitch server on the CPU (the batched kernel's plain
version): bucketing, dynamic flush, failure isolation, backpressure,
cancellation, budget caps, warmup and latency counters; the scenarios of
tests/test_server.py that the port supports.

Jobs are held to the float64 oracle within 1 uint8 step (f32 against f64),
and where it is cheap to the JAX ``StitchServer(engine="xla")`` within 1;
the references run on the JAX package's own plan of the job.  Every future
waits a few seconds at most.
"""

import dataclasses
import threading
import time
from concurrent.futures import wait as fwait

import numpy as np
import pytest
import torch

from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.serve.server import StitchServer as JaxStitchServer
from imagestitching_tpu_torch import (CanvasLimits, MemoryBudget,
                                      RuntimeConfig, StitchOptions)
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.parallel import batch
from imagestitching_tpu_torch.runtime import spans, tiler
from imagestitching_tpu_torch.runtime.logger import get_logger
from imagestitching_tpu_torch.serve.server import (ServerOverloaded,
                                                   StitchServer)

CPU = RuntimeConfig(device="cpu")
T = 10                                  # seconds any future may take
rng = np.random.default_rng(21)


def rand_img(w, h, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def server(**kw):
    kw.setdefault("config", CPU)
    kw.setdefault("max_wait_s", 0.002)
    return StitchServer(**kw)


def _jax_opts(opts):
    return jax_config.StitchOptions(**dataclasses.asdict(opts))


def _oracle(shapes, opts, imgs):
    """The JAX package's oracle on its own plan of the job; ``shapes`` are
    ``(raw_w, raw_h)``."""
    plan = jax_layout.solve([jax_layout.ImageSpec(w, h) for w, h in shapes],
                            _jax_opts(opts))
    return oracle.stitch(plan, imgs)


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_single_job_matches_oracle_and_jax_server():
    imgs = [rand_img(32, 24), rand_img(24, 24)]
    opts = StitchOptions(gap=2)
    with server(max_batch=8) as s:
        out = s.submit(imgs, opts).result(timeout=T)
    assert _maxdiff(out, _oracle([(32, 24), (24, 24)], opts, imgs)) <= 1
    with JaxStitchServer(max_batch=8, max_wait_s=0.002, engine="xla") as js:
        assert _maxdiff(out, js.submit(imgs, _jax_opts(opts)).result(
            timeout=60)) <= 1


def test_batches_same_signature():
    with server(max_batch=4, max_wait_s=0.01) as s:
        jobs = []
        for _ in range(8):
            imgs = [rand_img(40, 20), rand_img(20, 30)]
            jobs.append((imgs, s.submit(imgs)))
        for imgs, fut in jobs:
            assert _maxdiff(fut.result(timeout=T), _oracle(
                [(40, 20), (20, 30)], StitchOptions(), imgs)) <= 1
        st = s.stats()
    assert st["jobs"] == 8
    assert st["batches"] <= 4               # bucketed, not per job


def test_mixed_signatures():
    with server(max_batch=8, max_wait_s=0.005) as s:
        fa = s.submit([rand_img(16, 16)])
        fb = s.submit([rand_img(24, 16), rand_img(24, 8)],
                      StitchOptions(direction="horizontal"))
        assert fa.result(timeout=T).shape == (16, 16, 3)
        plan_b = solve([ImageSpec(24, 16), ImageSpec(24, 8)],
                       StitchOptions(direction="horizontal"))
        assert fb.result(timeout=T).shape == (plan_b.canvas_h,
                                              plan_b.canvas_w, 3)


def test_background_not_shared_across_jobs():
    o_black = StitchOptions(gap=6, background=(0, 0, 0))
    o_red = StitchOptions(gap=6, background=(255, 0, 0))
    with server(max_batch=8, max_wait_s=0.01) as s:
        imgs1 = [rand_img(20, 12), rand_img(20, 10)]
        imgs2 = [rand_img(20, 12), rand_img(20, 10)]
        f1, f2 = s.submit(imgs1, o_black), s.submit(imgs2, o_red)
        out1, out2 = f1.result(timeout=T), f2.result(timeout=T)
    assert tuple(out1[12, 0]) == (0, 0, 0)
    assert tuple(out2[12, 0]) == (255, 0, 0)
    assert _maxdiff(out2, _oracle([(20, 12), (20, 10)], o_red, imgs2)) <= 1


def test_failure_isolation_at_submit():
    with server(max_batch=4, max_wait_s=0.005) as s:
        futs = [s.submit([rand_img(16, 16)]) for _ in range(3)]
        with pytest.raises(ValueError):
            s.submit([], StitchOptions())
        for f in futs:
            assert f.result(timeout=T).shape == (16, 16, 3)
        assert s.stats()["pending"] == 0


def test_poisoned_job_fails_alone_by_split_retry(monkeypatch):
    """A batch that fails splits and retries its halves, so only the job
    that really fails gets the error."""
    real = batch.BatchedStitch.__call__

    def poisoned(self, slots):
        # each slot is its jobs' own arrays
        if any((a == 7).all() for jobs in slots for a in jobs):
            raise RuntimeError("poisoned job")
        return real(self, slots)

    monkeypatch.setattr(batch.BatchedStitch, "__call__", poisoned)
    get_logger().clear()
    with server(max_batch=4, max_wait_s=5.0) as s:
        good = [[rand_img(20, 12)] for _ in range(3)]
        futs = [s.submit(g) for g in good[:2]]
        bad = s.submit([np.full((12, 20, 3), 7, np.uint8)])
        futs.append(s.submit(good[2]))          # 4th submit: batch is full
        with pytest.raises(RuntimeError, match="poisoned"):
            bad.result(timeout=T)
        for g, f in zip(good, futs):
            np.testing.assert_array_equal(f.result(timeout=T), g[0])
        st = s.stats()
    assert st["failed"] == 1 and st["jobs"] == 3 and st["pending"] == 0
    tags = [r["tag"] for r in get_logger().ring()]
    assert "serve.batch_fail_retry_split" in tags


def _one_flush(jobs, opts, **kw):
    """Every job in one flush (``max_batch`` is their number): the
    canvases, in submission order, and the worker's span records."""
    t0 = time.perf_counter_ns()
    with server(max_batch=len(jobs), max_wait_s=30.0, **kw) as s:
        futs = [s.submit(imgs, opts) for imgs in jobs]
        outs = [f.result(timeout=T) for f in futs]
        assert s.stats()["batches"] == 1
        worker = s._thread.ident
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    return outs, [r for r in records if r.thread == worker]


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("c", [1, 3])
def test_server_canvases_equal_batched_stitch_on_stacked_inputs(c, engine):
    """The flush hands its jobs' own arrays, which the upload copies into
    their rows on the device: the canvases are those of ``BatchedStitch``
    on the same jobs stacked on the host, bit for bit."""
    opts = StitchOptions(gap=3)
    jobs = [[rand_img(40, 24, c), rand_img(24, 30, c)] for _ in range(3)]
    outs, _ = _one_flush(jobs, opts, engine=engine)
    plan = solve([ImageSpec(40, 24), ImageSpec(24, 30)], opts)
    want = batch.BatchedStitch(plan, 3, c, engine=engine, device="cpu")(
        [np.stack([imgs[k] for imgs in jobs]) for k in range(2)])
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, want[i])


def test_flush_hands_the_jobs_own_arrays(monkeypatch):
    """No host copy: each slot that ``BatchedStitch`` receives is the list
    of its jobs' submitted arrays themselves, in job order."""
    real = batch.BatchedStitch.__call__
    seen = []

    def spy(self, slots):
        seen.append(slots)
        return real(self, slots)

    monkeypatch.setattr(batch.BatchedStitch, "__call__", spy)
    jobs = [[rand_img(20, 12), rand_img(16, 12)] for _ in range(3)]
    outs, _ = _one_flush(jobs, StitchOptions())
    (slots,) = seen
    assert len(slots) == 2
    for k, slot in enumerate(slots):
        assert isinstance(slot, list) and len(slot) == 3
        assert all(a is imgs[k] for a, imgs in zip(slot, jobs))
    plan = solve([ImageSpec(20, 12), ImageSpec(16, 12)], StitchOptions())
    assert [o.shape for o in outs] == [(plan.canvas_h, plan.canvas_w, 3)] * 3


@pytest.mark.parametrize("form", ["server", "stack"])
def test_upload_counts_direct(form):
    """A flush's upload copies its jobs' arrays into their rows (``direct``
    1); a whole stack is uploaded in one copy (0)."""
    jobs = [[rand_img(20, 12)] for _ in range(2)]
    if form == "server":
        _, records = _one_flush(jobs, StitchOptions())
    else:
        plan = solve([ImageSpec(20, 12)], StitchOptions())
        t0 = time.perf_counter_ns()
        batch.BatchedStitch(plan, 2, device="cpu")(
            [np.stack([imgs[0] for imgs in jobs])])
        records, _ = spans.snapshot(t0, time.perf_counter_ns())
        records = [r for r in records if r.thread == threading.get_ident()]
    (h2d,) = [r for r in records if r.name == "batch.h2d"]
    assert h2d.counts == {"card": 0, "direct": int(form == "server")}


def test_close_flushes():
    s = server(max_batch=64, max_wait_s=30.0)
    imgs = [rand_img(16, 16)]
    fut = s.submit(imgs)
    s.close()
    np.testing.assert_array_equal(fut.result(timeout=T), imgs[0])
    with pytest.raises(RuntimeError):
        s.submit(imgs)


def test_queue_backpressure():
    # bounded by PENDING jobs, not raw queue depth: the 4th submit is
    # rejected while the first three sit in their bucket
    s = server(max_batch=8, max_wait_s=30.0, max_queue=3)
    try:
        jobs = [s.submit([rand_img(8, 8)]) for _ in range(3)]
        with pytest.raises(ServerOverloaded, match="queue full"):
            s.submit([rand_img(8, 8)])
    finally:
        s.close()
    for f in jobs:
        assert f.result(timeout=T).shape == (8, 8, 3)


def test_budget_caps_batch_proactively():
    specs = [ImageSpec(64, 48), ImageSpec(48, 64)]
    plan = solve(specs, StitchOptions(gap=2))
    per_job = tiler.resident_peak_bytes(plan, 3)
    cfg = RuntimeConfig(device="cpu",
                        budget=MemoryBudget(hbm_bytes=3 * per_job + 1))
    get_logger().clear()
    with server(max_batch=64, max_wait_s=0.05, config=cfg) as s:
        assert s._batch_cap(plan, 3) == 3
        jobs = []
        for _ in range(10):
            imgs = [rand_img(64, 48), rand_img(48, 64)]
            jobs.append((imgs, s.submit(imgs, StitchOptions(gap=2))))
        for imgs, fut in jobs:
            assert _maxdiff(fut.result(timeout=T), _oracle(
                [(64, 48), (48, 64)], StitchOptions(gap=2), imgs)) <= 1
        st = s.stats()
    assert st["jobs"] == 10
    assert st["batches"] >= 4               # ceil(10 / 3) flushes at least
    assert "serve.batch_capped" in [r["tag"] for r in get_logger().ring()]


def test_signature_lru_bounded():
    with server(max_batch=2, max_wait_s=0.0, max_signatures=2) as s:
        first = [rand_img(10, 10)]
        assert s.submit(first).result(timeout=T).shape == (10, 10, 3)
        for w in (12, 14, 16, 18):
            assert s.submit([rand_img(w, 8)]).result(
                timeout=T).shape == (8, w, 3)
        assert len(s._compiled) <= 2
        out = s.submit(first).result(timeout=T)
    np.testing.assert_array_equal(out, first[0])


def test_cancelled_future_does_not_poison_batch():
    with server(max_batch=4, max_wait_s=5.0) as s:
        f_cancel = s.submit([rand_img(20, 12)])
        assert f_cancel.cancel()            # still queued: cancel wins
        mates = [s.submit([rand_img(20, 12)]) for _ in range(3)]
        for f in mates:
            assert f.result(timeout=T).shape == (12, 20, 3)
        done, not_done = fwait([f_cancel], timeout=T)
        assert not not_done and f_cancel.cancelled()
        assert s.stats()["pending"] == 0
        s.close()
        st = s.stats()
    assert st["jobs"] == 3 and st["failed"] == 0


def test_overload_rejects_before_normalization(monkeypatch):
    import imagestitching_tpu_torch.api as api_mod

    def boom(a):
        raise AssertionError("normalization ran before admission")

    s = server(max_batch=2, max_queue=1)
    try:
        with s.admission():                 # hold the only slot
            assert s.stats()["pending"] == 1
            monkeypatch.setattr(api_mod, "_as_uint8", boom)
            with pytest.raises(ServerOverloaded):
                s.submit([rand_img(8, 8, 4)])
        monkeypatch.undo()
        assert s.stats()["pending"] == 0
        assert s.submit([rand_img(8, 8)]).result(timeout=T).shape == (
            8, 8, 3)
    finally:
        s.close()


def test_config_limits_are_applied():
    cfg = RuntimeConfig(device="cpu", limits=CanvasLimits(max_side=40))
    with server(max_batch=4, config=cfg) as s:
        out = s.submit([rand_img(64, 80)]).result(timeout=T)
    assert max(out.shape[:2]) <= 40


def _flat_white(arr):
    a = arr[:, :, -1:].astype(np.float64) / 255.0
    color = arr[:, :, :-1].astype(np.float64) * a + 255.0 * (1.0 - a)
    return np.clip(np.floor(color + 0.5), 0, 255).astype(np.uint8)


def test_rgba_flattens_like_decode():
    imgs = [rand_img(32, 24, 4), rand_img(28, 20, 4)]
    with server(max_batch=4) as s:
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=T)
    want = _oracle([(32, 24), (28, 20)], StitchOptions(gap=2),
                   [_flat_white(a) for a in imgs])
    assert out.shape[2] == 3 and _maxdiff(out, want) <= 1


def test_mixed_gray_rgb_promotes():
    imgs = [rng.integers(0, 256, (24, 32), np.uint8), rand_img(28, 20)]
    with server(max_batch=4) as s:
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=T)
    want = _oracle([(32, 24), (28, 20)], StitchOptions(gap=2),
                   [np.repeat(imgs[0][:, :, None], 3, axis=2), imgs[1]])
    assert out.shape[2] == 3 and _maxdiff(out, want) <= 1


def test_gray_and_rgb_same_geometry_bucket_separately():
    g, c = [rand_img(32, 24, 1)], [rand_img(32, 24)]
    with server(max_batch=8, max_wait_s=0.05) as s:
        fg, fc = s.submit(g), s.submit(c)
        og, oc = fg.result(timeout=T), fc.result(timeout=T)
        assert s.stats()["batches"] == 2
    np.testing.assert_array_equal(og, g[0])
    np.testing.assert_array_equal(oc, c[0])


def test_warmup_runs_each_size_then_serves():
    """No pow-2 padding: a warmed size is the size a flush of that many
    jobs runs."""
    opts = StitchOptions(gap=2)
    with server(max_batch=8) as s:
        info = s.warmup([(24, 32), (20, 28)], opts, batch_sizes=(1, 5))
        assert info == {"engine": "auto", "batches": [1, 5],
                        "signature_cached": True}
        assert s.stats()["warmups"] == 2 and s.stats()["signatures"] == 1
        (per_size,) = s._compiled.values()
        assert set(per_size) == {(1, 3), (5, 3)}
        imgs = [rand_img(32, 24), rand_img(28, 20)]
        out = s.submit(imgs, opts).result(timeout=T)
        (per_size,) = s._compiled.values()
        assert set(per_size) == {(1, 3), (5, 3)}   # the warmed 1-job entry
    assert _maxdiff(out, _oracle([(32, 24), (28, 20)], opts, imgs)) <= 1


def test_warmup_clamps_to_cap_and_max_batch(monkeypatch):
    with server(max_batch=16, max_wait_s=30.0) as s:
        monkeypatch.setattr(s, "_batch_cap", lambda plan, ch: 3)
        assert s.warmup([(16, 16)], batch_sizes=(10, 2))["batches"] == [2, 3]
    with server(max_batch=4, max_wait_s=30.0) as s:
        assert s.warmup([(16, 16)], batch_sizes=(10,))["batches"] == [4]


@pytest.mark.parametrize("kw,match", [
    (dict(shapes=[(24,)]), "warmup shape"),
    (dict(shapes=[(24, 32, 4)]), "channels"),
    (dict(shapes=[(24, 32)], orientations=[1, 1]), "orientations"),
    (dict(shapes=[(16, 16)], batch_sizes=()), "non-empty"),
    (dict(shapes=[(16, 16)], batch_sizes=3), "batch_sizes"),
])
def test_warmup_validation(kw, match):
    with server(max_batch=4) as s:
        with pytest.raises(ValueError, match=match):
            s.warmup(**kw)
        assert s.stats()["warmups"] == 0


def test_concurrent_clients_with_cancels():
    """Client threads submitting and sometimes cancelling: every future is
    notified, slots quiesce to 0 and jobs + failed + cancelled add up."""
    with server(max_batch=4, max_wait_s=0.002) as s:
        lock = threading.Lock()
        jobs = []

        def client(tid):
            trng = np.random.default_rng(100 + tid)
            for k in range(4):
                imgs = [trng.integers(0, 256, (12, 20, 3), np.uint8)]
                fut = s.submit(imgs, StitchOptions(gap=float(tid)))
                with lock:
                    jobs.append((imgs, float(tid), fut))
                if k == 1:
                    fut.cancel()      # may win (queued) or lose (flushed)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
            assert not t.is_alive()
        done, not_done = fwait([f for _, _, f in jobs], timeout=T)
        assert not not_done
        st = s.stats()
    assert st["pending"] == 0
    n_cancelled = 0
    for imgs, gap, fut in jobs:
        if fut.cancelled():
            n_cancelled += 1
            continue
        assert _maxdiff(fut.result(timeout=0), _oracle(
            [(20, 12)], StitchOptions(gap=gap), imgs)) <= 1
    assert st["jobs"] + st["failed"] + n_cancelled == len(jobs)
    assert st["failed"] == 0


def test_latency_metrics():
    with server(max_batch=4) as s:
        s.warmup([(16, 16)], batch_sizes=(4,))
        st = s.stats()
        assert st["flush_s"] == 0.0 and st["queue_wait_s"] == 0.0
        futs = [s.submit([rand_img(16, 16)]) for _ in range(3)]
        for f in futs:
            f.result(timeout=T)
        st = s.stats()
    assert st["flush_s"] > 0.0 and 0.0 < st["stack_s"] <= st["flush_s"]
    assert 0.0 <= st["queue_wait_max_s"] <= st["queue_wait_s"]
    assert st["jobs"] == 3
    assert {"jobs", "batches", "failed", "warmups", "queue_wait_s",
            "queue_wait_max_s", "flush_s", "pending", "max_queue",
            "signatures"} <= set(st)          # the JAX server's keys


def test_deep_downscale_beyond_the_tpu_tap_cap_is_served():
    """4 -> 64 min-mode lanczos3 needs K = 97 taps, beyond the TPU kernel's
    64: the JAX server demotes it to XLA; the port runs it on its kernel
    path (here the plain version) and is right."""
    opts = StitchOptions(mode="min", filter="lanczos3", supersample=False)
    imgs = [rand_img(4, 4), rand_img(64, 64)]
    plan = solve([ImageSpec(4, 4), ImageSpec(64, 64)], opts)
    from imagestitching_tpu_torch.ops import torch_compose
    k = max(torch_compose.placement_taps(p, plan.filter)[axis]["w"].shape[1]
            for p in plan.placements for axis in ("rows", "cols"))
    assert k > 64
    with server(max_batch=2, max_wait_s=0.0) as s:
        out = s.submit(imgs, opts).result(timeout=T)
        assert s.stats()["failed"] == 0
    assert _maxdiff(out, _oracle([(4, 4), (64, 64)], opts, imgs)) <= 1


def test_empty_span_placement_is_served():
    specs = [ImageSpec(33, 4), ImageSpec(4, 4)]
    opts = StitchOptions(direction="vertical", mode="min")
    plan = solve(specs, opts)
    assert any(p.row_span[0] == p.row_span[1] for p in plan.placements)
    imgs = [rand_img(33, 4), rand_img(4, 4)]
    with server(max_batch=2) as s:
        out = s.submit(imgs, opts).result(timeout=T)
        assert s.stats()["failed"] == 0
    assert _maxdiff(out, _oracle([(33, 4), (4, 4)], opts, imgs)) <= 1


def test_torch_engine_serves_the_same_bits():
    imgs = [rand_img(40, 30), rand_img(30, 20)]
    with server(max_batch=2) as s, server(max_batch=2, engine="torch") as t:
        a = s.submit(imgs).result(timeout=T)
        b = t.submit(imgs).result(timeout=T)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw,exc", [
    (dict(engine="pallas"), ValueError),
    (dict(engine="cuda"), ValueError),            # on a cpu device
    # no config.mesh: a mesh of every card, and this host has none
    (dict(use_mesh=True), RuntimeError),
])
def test_server_arguments(kw, exc):
    if kw.get("use_mesh") and torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(exc):
        server(**kw)


def test_merge_overlap_job_is_trimmed_in_submit():
    """A ``merge_overlap`` job is trimmed in ``submit`` (on the server's
    device, ``serve.merge`` logged) and then batched like any other: the
    merged pair is the capture it was cut from, bit for bit (twin of
    tests/test_merge_overlap.py:160-167)."""
    base = rand_img(64, 500)
    a, b = base[:260], base[210:]
    get_logger().clear()
    with server(max_batch=4) as s:
        out = s.submit([a, b], StitchOptions(merge_overlap=True)).result(
            timeout=T)
        assert s.stats()["pending"] == 0 and s.stats()["jobs"] == 1
    np.testing.assert_array_equal(out, base)
    merges = [e for e in get_logger().ring() if e["tag"] == "serve.merge"]
    assert [e["trims"] for e in merges] == [[0, 50]]


def test_cuda_device_without_cuda_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StitchServer(config=RuntimeConfig(device="cuda"))
