"""The port's overlapped scheduler (decode || upload || compute) on the CPU:
``api.stitch``'s overlap branch -> ``pipeline.run_overlapped``, the pure-copy
branch ``api._stitch_blit_overlapped``, and the OOM demotion to the banded
rung, against the JAX package's same functions (XLA engine) and the float64
oracle.

Same seeded numpy inputs to both packages.  Tolerances: port against JAX
and the oracle within 1 uint8 step (f32 sums in another order); the port's
overlapped canvas against its own non-overlapped one bit for bit (the same
placement step on the same sources); pure-copy jobs bit for bit everywhere.
On the CPU the kernels' wrappers run their plain version, so OOMs and
device faults are injected with monkeypatch.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.runtime import logger as jax_logger
from imagestitching_tpu.runtime import pipeline as jax_pipeline
from imagestitching_tpu_torch import (MemoryBudget, RuntimeConfig,
                                      StitchOptions, api)
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.runtime import decoding, pipeline, tiler
from imagestitching_tpu_torch.runtime.logger import StitchLogger, set_logger

CPU = RuntimeConfig(device="cpu")
NEVER = RuntimeConfig(device="cpu", overlap="never")
JAX_XLA = jax_config.RuntimeConfig(engine="xla")
# BASELINE config 3 (benchmarks/run_all.py:97-99) at 1/8 of its sides, with
# its orientations: 5 resampled placements and 4 copies
_CONFIG3_8 = [(240, 135, 1), (135, 240, 6), (180, 135, 3), (160, 120, 8),
              (250, 187, 1), (135, 135, 5), (200, 150, 2), (150, 200, 7),
              (240, 180, 4)]
_OPTS = StitchOptions(direction="horizontal", mode="min", gap=4,
                      max_images=None)


def _images(shapes, seed=3, c=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, c), np.uint8) for w, h, _ in shapes]


def _job(shapes=_CONFIG3_8, opts=_OPTS, seed=3):
    """(plan, images, loaders) of one job."""
    imgs = _images(shapes, seed)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    return plan, imgs, [(lambda a=a: a) for a in imgs]


def _jax_plan(shapes, opts):
    return jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(**dataclasses.asdict(opts)))


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _never(plan, imgs):
    out, m = pipeline.run(plan, imgs, NEVER)
    assert m.strategy == "resident"
    return out


def _drawn(plan):
    return [p.index for p in plan.placements
            if p.row_span[1] > p.row_span[0] and p.col_span[1] > p.col_span[0]]


@pytest.fixture
def log():
    logger = StitchLogger()
    set_logger(logger)
    yield logger
    set_logger(StitchLogger())


def _events(logger, tag):
    return [e for e in logger.ring() if e["tag"] == tag]


def test_overlapped_equals_never_jax_and_oracle(log):
    """Config 3 at 1/8: the overlapped canvas equals the port's resident one
    bit for bit, and the JAX package's overlapped canvas and the oracle
    within 1; the plan event names the tiler's strategy under
    ``overlapped/``, and the done event carries the JAX event's fields."""
    plan, imgs, loaders = _job()
    out, m = pipeline.run_overlapped(plan, loaders, CPU)
    assert m.strategy == "overlapped"
    plans = [e["strategy"] for e in _events(log, "pipeline.plan")]
    assert plans == ["overlapped/resident"]
    np.testing.assert_array_equal(out, _never(plan, imgs))
    jax_log = jax_logger.StitchLogger()
    jax_logger.set_logger(jax_log)
    try:
        want, jm = jax_pipeline.run_overlapped(
            _jax_plan(_CONFIG3_8, _OPTS), loaders, JAX_XLA)
    finally:
        jax_logger.set_logger(jax_logger.StitchLogger())
    assert jm.strategy == "overlapped"
    assert _maxdiff(out, np.asarray(want)) <= 1
    assert _maxdiff(out, oracle.stitch(_jax_plan(_CONFIG3_8, _OPTS),
                                       imgs)) <= 1
    done = _events(log, "pipeline.overlapped_done")
    jax_done = [e for e in jax_log.ring()
                if e["tag"] == "pipeline.overlapped_done"]
    assert len(done) == len(jax_done) == 1
    assert set(done[0]) == set(jax_done[0])


def test_overlapped_metrics(log):
    """``h2d_bytes`` counts every drawn source once; ``prepare_s`` is the
    decode wall, ``stage_wait_max_s`` is one of the staging calls summed in
    ``stage_wait_s``, ``readback_s`` and ``total_s`` are set."""
    plan, imgs, loaders = _job()
    _, m = pipeline.run_overlapped(plan, loaders, CPU)
    assert m.h2d_bytes == sum(imgs[i].nbytes for i in _drawn(plan))
    assert 0 < m.stage_wait_max_s <= m.stage_wait_s
    assert 0 < m.prepare_s <= m.total_s
    assert m.readback_s > 0 and m.compute_s >= 0
    assert m.transport_rtt_s >= 0
    assert (m.canvas_w, m.canvas_h) == (plan.canvas_w, plan.canvas_h)
    assert m.est_peak_bytes == tiler.plan_execution(
        plan, CPU.budget).est_peak_bytes


def test_keep_on_device_returns_tensor():
    plan, imgs, loaders = _job()
    out, m = pipeline.run_overlapped(plan, loaders, CPU, keep_on_device=True)
    assert isinstance(out, torch.Tensor) and m.readback_s == 0
    np.testing.assert_array_equal(out.numpy(), _never(plan, imgs))


def test_completion_order_does_not_matter(monkeypatch):
    """Loaders that land in reverse order are drawn in the order they land,
    and the canvas is the same."""
    plan, imgs, _ = _job()
    n = len(imgs)

    def slow(i):
        time.sleep(0.04 * (n - i))
        return imgs[i]

    loaders = [(lambda i=i: slow(i)) for i in range(n)]
    order = []
    real = cuda_resize.draw_placement

    def spy(src, p, *a, **k):
        order.append(p.index)
        return real(src, p, *a, **k)

    monkeypatch.setattr(cuda_resize, "draw_placement", spy)
    out, m = pipeline.run_overlapped(
        plan, loaders, dataclasses.replace(CPU, decode_threads=n))
    assert m.strategy == "overlapped"
    assert sorted(order) == _drawn(plan)
    assert order[0] == max(order) and order != sorted(order)
    np.testing.assert_array_equal(out, _never(plan, imgs))


def test_decoded_shape_unlike_header_raises():
    plan, imgs, loaders = _job()
    loaders[4] = lambda: imgs[4][:-1]
    with pytest.raises(ValueError, match="header said"):
        pipeline.run_overlapped(plan, loaders, CPU)


@pytest.mark.parametrize("strategy", ["streamed", "banded"])
def test_budget_forced_plans(log, strategy):
    """A budget the resident plan does not fit: a streamed plan still runs
    the overlapped body (strategy ``overlapped``); a banded plan decodes,
    keeps the sources and runs the banded rung (``overlapped/banded``), with
    no OOM on the way.  Both equal the resident canvas bit for bit and the
    JAX package's same job within 1."""
    plan, imgs, loaders = _job()
    hbm = tiler.resident_peak_bytes(plan) - 1
    if strategy == "banded":
        hbm = max(3 * plan.canvas_w * plan.canvas_h // 2,
                  tiler.min_feasible_bytes(plan))
    budget = MemoryBudget(hbm_bytes=hbm)
    assert tiler.plan_execution(plan, budget).strategy == strategy
    out, m = pipeline.run_overlapped(
        plan, loaders, dataclasses.replace(CPU, budget=budget))
    want = "overlapped" if strategy == "streamed" else "overlapped/banded"
    assert m.strategy == want
    assert [e["strategy"] for e in _events(log, "pipeline.plan")] == [
        f"overlapped/{strategy}"]
    assert not _events(log, "pipeline.oom_retry")
    assert not _events(log, "pipeline.oom_redecode")
    np.testing.assert_array_equal(out, _never(plan, imgs))
    jout, jm = jax_pipeline.run_overlapped(
        _jax_plan(_CONFIG3_8, _OPTS), loaders, dataclasses.replace(
            JAX_XLA, budget=jax_config.MemoryBudget(hbm_bytes=hbm)))
    assert jm.strategy == want
    assert _maxdiff(out, np.asarray(jout)) <= 1


class _Counted:
    """Loaders that count their calls."""

    def __init__(self, imgs):
        self.imgs, self.calls = imgs, [0] * len(imgs)
        self.lock = threading.Lock()

    def loaders(self):
        def load(i):
            with self.lock:
                self.calls[i] += 1
            return self.imgs[i]
        return [(lambda i=i: load(i)) for i in range(len(self.imgs))]


def test_drain_oom_demotes_to_banded_with_redecode(log, monkeypatch):
    """Twin of tests/test_tiler_pipeline.py:357-385: an OOM that first
    surfaces at the drain demotes to the banded rung, which re-decodes the
    sources whose host copies were dropped."""
    plan, imgs, _ = _job()
    counted = _Counted(imgs)
    fired = []

    def drain_oom(device):
        if not fired:
            fired.append(True)
            raise RuntimeError("CUDA error: out of memory (simulated)")

    monkeypatch.setattr(pipeline, "_drain", drain_oom)
    out, m = pipeline.run_overlapped(plan, counted.loaders(), CPU)
    assert fired and m.strategy == "overlapped/banded"
    assert [e["failed"] for e in _events(log, "pipeline.oom_retry")] == [
        "overlapped-drain"]
    assert [e["n"] for e in _events(log, "pipeline.oom_redecode")] == [
        len(_drawn(plan))]
    assert counted.calls == [2 if i in _drawn(plan) else 1
                             for i in range(len(imgs))]
    np.testing.assert_array_equal(out, _never(plan, imgs))
    assert _maxdiff(out, oracle.stitch(_jax_plan(_CONFIG3_8, _OPTS),
                                       imgs)) <= 1


def test_loop_oom_demotes_to_banded(log, monkeypatch):
    """An OOM at the third upload drops the canvas and the ring; the two
    sources already drawn are decoded again, the rest were kept."""
    plan, imgs, _ = _job()
    counted = _Counted(imgs)
    real = pipeline._Stager.upload
    calls = []

    def upload(self, raw, *rest):
        calls.append(1)
        if len(calls) == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        return real(self, raw, *rest)

    monkeypatch.setattr(pipeline._Stager, "upload", upload)
    out, m = pipeline.run_overlapped(plan, counted.loaders(),
                                     dataclasses.replace(CPU,
                                                         decode_threads=1))
    assert m.strategy == "overlapped/banded"
    assert [e["failed"] for e in _events(log, "pipeline.oom_retry")] == [
        "overlapped"]
    assert [e["n"] for e in _events(log, "pipeline.oom_redecode")] == [2]
    assert sum(counted.calls) == len(imgs) + 2
    np.testing.assert_array_equal(out, _never(plan, imgs))


def test_canvas_oom_demotes_without_redecode(log, monkeypatch):
    plan, imgs, _ = _job()
    counted = _Counted(imgs)

    def no_canvas(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(pipeline, "new_canvas", no_canvas)
    out, m = pipeline.run_overlapped(plan, counted.loaders(), CPU)
    assert m.strategy == "overlapped/banded" and m.transport_rtt_s == 0
    assert [e["failed"] for e in _events(log, "pipeline.oom_retry")] == [
        "overlapped-alloc"]
    assert not _events(log, "pipeline.oom_redecode")
    assert counted.calls == [1] * len(imgs)
    np.testing.assert_array_equal(out, _never(plan, imgs))


def test_oom_on_every_rung_raises_memory_error(log, monkeypatch):
    plan, _, loaders = _job()

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(pipeline, "new_canvas", oom)
    monkeypatch.setattr(pipeline, "_run_banded", oom)
    with pytest.raises(MemoryError, match="every strategy") as info:
        pipeline.run_overlapped(plan, loaders, CPU)
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    ex = tiler.plan_execution(plan, CPU.budget)
    assert [(e["failed"], e["band"]) for e in
            _events(log, "pipeline.oom_retry")] == (
        [("overlapped-alloc", None)]
        + [("banded", b) for b in pipeline._banded_bands(ex, plan)])


def test_device_fault_is_not_an_oom(log, monkeypatch):
    """A sticky device fault propagates: nothing demotes, and the decode
    pool is cancelled."""
    plan, _, loaders = _job()
    pools = []
    real = decoding.iter_decoded

    def spy(*a, **k):
        pools.append(real(*a, **k))
        return pools[-1]

    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(decoding, "iter_decoded", spy)
    monkeypatch.setattr(cuda_resize, "draw_placement", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pipeline.run_overlapped(plan, loaders, CPU)
    assert not _events(log, "pipeline.oom_retry")
    assert len(pools) == 1 and pools[0]._cancelled.is_set()


def test_decode_error_closes_the_pool(log, monkeypatch):
    """Twin of tests/test_api_cli.py:455-485 on the overlapped body: a decode
    error aborts the job, is logged and cancels the pool."""
    plan, imgs, loaders = _job()
    pools = []
    real = decoding.iter_decoded

    def spy(*a, **k):
        pools.append(real(*a, **k))
        return pools[-1]

    def bad():
        raise OSError("decode exploded")

    loaders[2] = bad
    monkeypatch.setattr(decoding, "iter_decoded", spy)
    with pytest.raises(OSError, match="decode exploded"):
        pipeline.run_overlapped(plan, loaders, CPU)
    assert len(pools) == 1 and pools[0]._cancelled.is_set()
    assert [e["index"] for e in
            _events(log, "pipeline.overlapped_decode_fail")] == [2]


def test_blit_overlapped_decode_error_closes_pool(monkeypatch):
    """Twin of tests/test_api_cli.py:455-485."""
    from imagestitching_tpu_torch.core import geometry

    plan = solve([ImageSpec(48, 30)] * 3, StitchOptions())
    copies = geometry.plan_copy_offsets(plan)
    assert copies is not None
    good = np.zeros((30, 48, 3), np.uint8)

    def bad():
        raise RuntimeError("decode exploded")

    pools = []
    real = decoding.iter_decoded

    def spy(*a, **kw):
        pools.append(real(*a, **kw))
        return pools[-1]

    monkeypatch.setattr(decoding, "iter_decoded", spy)
    with pytest.raises(RuntimeError, match="decode exploded"):
        api._stitch_blit_overlapped(plan, [lambda: good, bad, lambda: good],
                                    CPU, lambda *a: None, copies)
    assert len(pools) == 1 and pools[0]._cancelled.is_set()


def test_profile_writes_a_trace_and_stops_on_errors(tmp_path, monkeypatch,
                                                    log):
    """``profile=True`` writes a torch.profiler trace under
    ``$IMAGESTITCH_TRACE_DIR``; a failing job stops the profiler too, so the
    next profiled job runs."""
    monkeypatch.setenv("IMAGESTITCH_TRACE_DIR", str(tmp_path))
    plan, imgs, loaders = _job(_CONFIG3_8[-3:], seed=5)
    cfg = dataclasses.replace(CPU, profile=True)

    def bad():
        raise OSError("decode exploded")

    with pytest.raises(OSError):
        pipeline.run_overlapped(plan, [loaders[0], bad, loaders[2]], cfg)
    out, _ = pipeline.run_overlapped(plan, loaders, cfg)
    np.testing.assert_array_equal(out, _never(plan, imgs))
    traces = [e["trace"] for e in _events(log, "pipeline.profile")]
    assert len(traces) == 2
    assert all(t.startswith(str(tmp_path)) for t in traces)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        t.rsplit("/", 1)[1] for t in traces)


# ------------------------------------------------------------- api.stitch

def test_stitch_routes_big_jobs_to_the_overlapped_body(tmp_path):
    """9 files take the overlap branch under ``overlap="auto"``; the canvas
    equals ``overlap="never"`` bit for bit and the JAX package's
    ``stitch`` within 1."""
    imgs = _images(_CONFIG3_8)
    paths = []
    for i, a in enumerate(imgs):
        paths.append(tmp_path / f"{i}.png")
        Image.fromarray(a).save(paths[-1])
    out, m = api.stitch(paths, options=_OPTS, config=CPU,
                        return_metrics=True)
    assert m.strategy == "overlapped"
    never, mn = api.stitch(paths, options=_OPTS, config=NEVER,
                           return_metrics=True)
    assert mn.strategy == "resident"
    np.testing.assert_array_equal(out, never)
    want = jax_api.stitch(paths, options=jax_config.StitchOptions(
        **dataclasses.asdict(_OPTS)), config=JAX_XLA)
    assert _maxdiff(out, want) <= 1


@pytest.mark.parametrize("overlap,n,expect", [
    ("always", 2, "overlapped"), ("auto", 2, "resident"),
    ("auto", 7, "overlapped"), ("never", 9, "resident")])
def test_overlap_knob(overlap, n, expect):
    shapes = _CONFIG3_8[-n:]
    imgs = _images(shapes)
    items = [(a, o) for a, (_, _, o) in zip(imgs, shapes)]
    cfg = dataclasses.replace(CPU, overlap=overlap)
    out, m = api.stitch(items, options=_OPTS, config=cfg,
                        return_metrics=True)
    assert m.strategy == expect
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], _OPTS)
    np.testing.assert_array_equal(out, _never(plan, imgs))


def test_stitch_host_blit_overlapped_big_task(tmp_path):
    """Twin of tests/test_api_cli.py:376-391: 8 equal-size files take the
    overlap branch and paste on the host, bit for bit equal to the oracle
    and to the JAX package."""
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (30, 48, 3), np.uint8) for _ in range(8)]
    paths = []
    for i, a in enumerate(imgs):
        paths.append(tmp_path / f"blit{i}.png")
        Image.fromarray(a).save(paths[-1])
    out, m = api.stitch(paths, gap=2, config=RuntimeConfig(device="cuda"),
                        return_metrics=True)
    assert m.strategy == "host-blit"
    plan = jax_layout.solve([jax_layout.ImageSpec(48, 30)] * 8,
                            jax_config.StitchOptions(gap=2))
    np.testing.assert_array_equal(out, oracle.stitch(plan, imgs))
    jout, jm = jax_api.stitch(paths, gap=2, return_metrics=True)
    assert jm.strategy == "host-blit"
    np.testing.assert_array_equal(out, jout)


def test_stitch_host_blit_respects_engine_pin():
    """Twin of tests/test_api_cli.py:394-398."""
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (16, 16, 3), np.uint8) for _ in range(8)]
    _, m = api.stitch(imgs, config=RuntimeConfig(engine="torch",
                                                 device="cpu"),
                      return_metrics=True)
    assert m.strategy == "overlapped"
    _, m = api.stitch(imgs, config=CPU, return_metrics=True)
    assert m.strategy == "host-blit"


def test_concurrent_overlapped_stitch_threads():
    """Twin of tests/test_api_cli.py:401-441 on the overlap branch: jobs of
    several plans from several threads at once, each equal to its own
    non-overlapped canvas."""
    jobs = []
    for k in range(6):
        shapes = [(40 + 8 * ((k + i) % 3), 30 + 6 * (i % 2), 1 + (k + i) % 8)
                  for i in range(2 + k % 3)]
        opts = StitchOptions(direction="vertical" if k % 2 else "horizontal",
                             gap=k % 4)
        imgs = _images(shapes, seed=20 + k)
        jobs.append(([(a, o) for a, (_, _, o) in zip(imgs, shapes)], opts))
    cfg = dataclasses.replace(CPU, overlap="always")
    results, errors = [None] * len(jobs), []

    def work(i):
        try:
            results[i] = api.stitch(jobs[i][0], options=jobs[i][1],
                                    config=cfg, return_metrics=True)
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for (items, opts), (out, m) in zip(jobs, results):
        assert m.strategy in ("overlapped", "host-blit")
        np.testing.assert_array_equal(
            out, api.stitch(items, options=opts, config=NEVER))


def test_stitch_overlapped_gray_arrays_take_plain_path():
    """Twin of tests/test_api_cli.py:538-546."""
    rng = np.random.default_rng(10)
    imgs = [rng.integers(0, 256, (16, 24), np.uint8) for _ in range(7)]
    out, m = api.stitch(imgs, gap=2, config=CPU, return_metrics=True)
    small = api.stitch(imgs[:2], gap=2, config=CPU)
    assert m.strategy in ("resident", "host-blit")
    assert out.shape[2] == 1 and small.shape[2] == 1
    assert np.array_equal(out[:16], imgs[0][:, :, None])
    np.testing.assert_array_equal(
        out, jax_api.stitch(imgs, gap=2, config=JAX_XLA))


def test_stitch_overlapped_rgba_arrays_still_overlap():
    """Twin of tests/test_api_cli.py:549-558."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (16, 24 + i, 4), np.uint8)
            for i in range(7)]
    cfg = dataclasses.replace(CPU, overlap="always")
    out, m = api.stitch(imgs, gap=0, config=cfg, return_metrics=True)
    assert m.strategy == "overlapped"
    want = jax_api.stitch_arrays(
        imgs, options=jax_config.StitchOptions(gap=0), config=JAX_XLA)
    assert _maxdiff(out, want) <= 1
    np.testing.assert_array_equal(
        out, api.stitch_arrays(imgs, options=StitchOptions(gap=0),
                               config=CPU))


def test_cuda_overlapped_job_without_cuda_raises():
    """The card path never moves to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    imgs = _images(_CONFIG3_8)
    items = [(a, o) for a, (_, _, o) in zip(imgs, _CONFIG3_8)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.stitch(items, options=_OPTS, config=RuntimeConfig(device="cuda"))


@pytest.mark.parametrize("kw", [dict(overlap="sometimes"),
                                dict(decode_window=0)])
def test_overlap_config_validation(kw):
    with pytest.raises(ValueError):
        RuntimeConfig(device="cpu", **kw).validate()
    with pytest.raises(ValueError):
        jax_config.RuntimeConfig(**kw).validate()


def test_config_defaults_match_jax():
    port, ref = RuntimeConfig(), jax_config.RuntimeConfig()
    assert (port.overlap, port.decode_window, port.profile) == (
        ref.overlap, ref.decode_window, ref.profile) == ("auto", None, False)
    assert port.device == "cuda"
