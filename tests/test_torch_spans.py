"""The port's spans (``runtime/spans.py``) on the CPU: the records of an
overlapped ``stitch`` and of a ``StitchServer`` flush, the totals that are
sums of the same readings, the profiler ranges, the spans of a job that
raises, and the ring's drop report, alone and under contention; and the
canvas readback that the ``readback`` span times (``pipeline._read_back``).

The readback into pinned host memory exists only for a CUDA canvas, so its
test is marked ``cuda`` and skips without a card.  On a CUDA host:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""

import gc
import mmap
import sys
import threading
import time

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch import RuntimeConfig, StitchOptions, api
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.runtime import pipeline, spans
from imagestitching_tpu_torch.serve.server import StitchServer

CPU = RuntimeConfig(device="cpu")
T = 10                                  # seconds any future may take
# BASELINE config 3's orientations on nine small sources: an overlapped
# job (nine images) with resampled placements
_SHAPES = [(240, 135, 1), (135, 240, 6), (180, 135, 3), (160, 120, 8),
           (250, 187, 1), (135, 135, 5), (200, 150, 2), (150, 200, 7),
           (240, 180, 4)]
_OPTS = StitchOptions(direction="horizontal", mode="min", gap=4,
                      max_images=None)
_STAGE = ("stage.slot_wait", "stage.pin_copy", "stage.enqueue", "draw",
          "stage.fence")
_BATCH = ("batch.h2d", "batch.draw", "batch.sync", "batch.readback")


def _items(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, 3), np.uint8), o)
            for w, h, o in _SHAPES]


def _window(fn):
    """``fn()``'s result and the records that meet its interval."""
    t0 = time.perf_counter_ns()
    out = fn()
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    return out, records


def _job_spans(records):
    """The ``stitch`` root this thread recorded, and its job's other
    spans."""
    me = threading.get_ident()
    roots = [r for r in records if r.name == "stitch" and r.thread == me]
    assert len(roots) == 1
    root = roots[0]
    return root, [r for r in records
                  if r.job == root.job and r.span != root.span]


def _ns(records, *names):
    return sum(r.end_ns - r.start_ns for r in records if r.name in names)


def _stitch():
    return api.stitch(_items(), options=_OPTS, config=CPU,
                      return_metrics=True)


def test_overlapped_stitch_records_its_phases_under_one_root():
    (_, m), records = _window(_stitch)
    assert m.strategy == "overlapped"
    root, kids = _job_spans(records)
    assert root.parent == 0
    names = [r.name for r in kids]
    assert {n: names.count(n) for n in set(names)} == {
        "plan": 1, "decode": 9, **{n: 9 for n in _STAGE}, "drain": 1,
        "readback": 1}
    assert all(r.parent == root.span for r in kids)
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
               for r in kids)
    # decodes run on the pool's threads, the rest on the caller's
    assert all(r.thread != root.thread for r in kids if r.name == "decode")
    assert all(r.thread == root.thread for r in kids if r.name != "decode")
    # the readback alone counts: the pages it made resident, and the blocks
    # by which the pinned-host pool grew (none for a CPU canvas)
    (readback,) = [r for r in kids if r.counts]
    assert readback.name == "readback" and set(readback.counts) == {
        "new_pages", "pinned_new"}
    assert readback.counts["pinned_new"] == 0
    assert root.counts is None


def test_strided_sources_are_staged_as_their_contiguous_copies():
    """A caller's strided view goes into the pinned slot as it is (the copy
    into the slot makes it contiguous) and gives the same canvas."""
    views = [(np.concatenate([a, a], axis=1)[:, ::2], o)
             for a, o in _items()]
    assert not any(v.flags.c_contiguous for v, _ in views)
    got, m = api.stitch(views, options=_OPTS, config=CPU,
                        return_metrics=True)
    want = api.stitch([(np.ascontiguousarray(v), o) for v, o in views],
                      options=_OPTS, config=CPU)
    assert m.strategy == "overlapped"
    np.testing.assert_array_equal(got, want)


def test_overlapped_metrics_are_sums_of_the_spans():
    """Staging spans follow each other at one reading a boundary, so the
    totals equal the spans' sums exactly."""
    (_, m), records = _window(_stitch)
    root, kids = _job_spans(records)
    assert m.stage_wait_s == _ns(kids, *_STAGE) / 1e9
    assert m.readback_s == _ns(kids, "readback") / 1e9
    assert m.compute_s == _ns(kids, "drain") / 1e9
    per_source = [r.end_ns for r in kids if r.name == "stage.fence"]
    starts = [r.start_ns for r in kids if r.name == "stage.slot_wait"]
    assert m.stage_wait_max_s == max(
        b - a for a, b in zip(starts, per_source)) / 1e9
    (plan,) = [r for r in kids if r.name == "plan"]
    assert m.prepare_s == (max(starts) - plan.start_ns) / 1e9
    assert m.transport_rtt_s == 0
    for name in _STAGE[1:]:
        # each staging span starts at the reading that closed the one before
        assert ({r.start_ns for r in kids if r.name == name}
                <= {r.end_ns for r in kids})


def test_demoted_job_takes_the_banded_span(monkeypatch):
    def no_canvas(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")

    monkeypatch.setattr(pipeline, "new_canvas", no_canvas)
    (_, m), records = _window(_stitch)
    assert m.strategy == "overlapped/banded"
    root, kids = _job_spans(records)
    names = {r.name for r in kids}
    assert "banded" in names and not names & set(_STAGE)
    (banded,) = [r for r in kids if r.name == "banded"]
    assert banded.parent == root.span


def _serve(n_jobs=6, **kw):
    imgs = [a for a, _ in _items()]
    with StitchServer(max_batch=8, max_wait_s=0.05, config=CPU, **kw) as s:
        before = s.stats()
        t0 = time.perf_counter_ns()
        futs = [s.submit(imgs, _OPTS) for _ in range(n_jobs)]
        for f in futs:
            f.result(timeout=T)
        records, dropped = spans.snapshot(t0, time.perf_counter_ns())
        after = s.stats()
        worker = s._thread.ident
    assert not dropped
    return before, after, [r for r in records if r.thread == worker
                           or r.name == "serve.submit"]


def test_server_flush_and_jobs_record_their_spans():
    _, after, records = _serve()
    flushes = {r.span: r for r in records if r.name == "serve.flush"}
    assert len(flushes) == after["batches"] >= 1
    for f in flushes.values():
        kids = [r for r in records if r.parent == f.span]
        names = [r.name for r in kids if not r.name.startswith("serve.q")
                 and r.name != "serve.resolve"]
        assert names == ["serve.stack", "batch.h2d", "batch.draw",
                         "batch.sync", "batch.readback"]
        names = set(names)
        assert all(f.start_ns <= r.start_ns <= r.end_ns <= f.end_ns
                   for r in kids if r.name in names)
        (stack,) = [r for r in kids if r.name == "serve.stack"]
        assert stack.start_ns == f.start_ns
    # a one-device flush counts its jobs, no padding and one card, and its
    # batch spans count card 0; no other server span counts anything
    assert sum(f.counts["jobs"] for f in flushes.values()) == 6
    assert all(f.counts == {"jobs": f.counts["jobs"], "pad_jobs": 0,
                            "cards": 1} for f in flushes.values())
    assert all(r.counts == {"card": 0}
               for r in records if r.name.startswith("batch."))
    assert all(r.counts is None for r in records
               if r.name not in ("serve.flush", *_BATCH))
    submits = [r for r in records if r.name == "serve.submit"]
    assert len(submits) == 6 and all(r.parent == 0 for r in submits)
    assert len({r.job for r in submits}) == 6
    for name in ("serve.queue", "serve.resolve"):
        per_job = [r for r in records if r.name == name]
        assert sorted(r.job for r in per_job) == sorted(r.job
                                                        for r in submits)
        assert all(r.parent in flushes for r in per_job)
    for q in (r for r in records if r.name == "serve.queue"):
        assert q.end_ns == flushes[q.parent].start_ns


@pytest.mark.parametrize("stat,name", [("stack_s", "serve.stack"),
                                       ("flush_s", "serve.flush"),
                                       ("queue_wait_s", "serve.queue")])
def test_server_stats_are_sums_of_the_spans(stat, name):
    before, after, records = _serve()
    assert before[stat] == 0.0
    assert after[stat] == _ns(records, name) / 1e9


def test_profiler_sees_a_main_thread_span():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("test.profiled"):
            torch.ones(4).sum()
    assert "test.profiled" in {e.name for e in prof.events()}


def test_spans_need_the_private_range_class_only_under_a_profiler(
        monkeypatch):
    """Without ``_RecordFunctionFast`` spans still record; under a profiler
    a span says what is missing."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")
    with spans.span("test.plain") as s:
        pass
    assert s.end_ns >= s.start_ns
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError, match="_RecordFunctionFast"):
            with spans.span("test.profiled"):
                pass
    assert spans.current() == (0, 0)


def test_no_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(spans, "_profiler_range",
                        lambda name: opened.append(name))
    _window(_stitch)
    _serve(n_jobs=2)
    assert opened == []


def _drain_fault(monkeypatch):
    def drain(device):
        raise ValueError("device fault (simulated)")

    monkeypatch.setattr(pipeline, "_drain", drain)
    with pytest.raises(ValueError, match="simulated"):
        _stitch()
    return "stitch", {"plan", "decode", *_STAGE, "drain"}


def _flush_fault(monkeypatch):
    def fail(self, stacks):
        raise ValueError("batch fault (simulated)")

    monkeypatch.setattr(StitchServer, "_get_compiled",
                        lambda self, *a: fail.__get__(self))
    with StitchServer(max_batch=8, config=CPU) as s:
        fut = s.submit([a for a, _ in _items()], _OPTS)
        with pytest.raises(ValueError, match="simulated"):
            fut.result(timeout=T)
    return "serve.flush", {"serve.stack"}


@pytest.mark.parametrize("fault", [_drain_fault, _flush_fault])
def test_a_job_that_raises_closes_its_spans(fault, monkeypatch):
    t0 = time.perf_counter_ns()
    outer, inner = fault(monkeypatch)
    records, _ = spans.snapshot(t0, time.perf_counter_ns())
    (top,) = [r for r in records if r.name == outer]
    assert {r.name for r in records if r.parent == top.span} >= inner
    assert spans.current() == (0, 0)


def test_count_pages_counts_the_pages_first_touched():
    n = 16 << 20
    buf = mmap.mmap(-1, n)       # fresh pages, not memory the heap reuses
    a = np.frombuffer(buf, np.uint8)
    t0 = time.perf_counter_ns()
    with spans.span("test.touch", count_pages=True):
        a[:] = 1
    with spans.span("test.touch", count_pages=True):
        a[:] = 2
    with spans.span("test.plain"):
        pass
    del a
    buf.close()
    records, _ = spans.snapshot(t0, time.perf_counter_ns())
    fresh, again, plain = [r for r in records if r.name.startswith("test.")
                           and r.thread == threading.get_ident()]
    assert fresh.counts["new_pages"] >= 0.9 * n / 4096
    assert abs(again.counts["new_pages"]) < 0.1 * n / 4096
    assert plain.counts is None


@pytest.mark.parametrize("count_pages", [False, True])
def test_a_body_s_counts_sit_beside_new_pages(count_pages):
    t0 = time.perf_counter_ns()
    with spans.span("test.counts", count_pages=count_pages) as s:
        s.counts = {"pinned_new": 1}
    (r,) = [r for r in spans.snapshot(t0, time.perf_counter_ns())[0]
            if r.span == s.id]
    assert r.counts["pinned_new"] == 1
    assert set(r.counts) == ({"pinned_new", "new_pages"} if count_pages
                             else {"pinned_new"})


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6, 1), (3, 2, 4)])
def test_a_cpu_canvas_reads_back_unpinned(shape, monkeypatch):
    """``.cpu().numpy()``: the canvas's bytes as a writable C-contiguous
    uint8 array that outlives the tensor, with no pinned memory asked
    for and no pinned block counted."""
    asked = []
    empty = torch.empty

    def spy(*a, **k):
        asked.append(bool(k.get("pin_memory")))
        return empty(*a, **k)

    monkeypatch.setattr(torch, "empty", spy)
    canvas = torch.randint(0, 256, shape, dtype=torch.uint8)
    want = canvas.numpy().copy()
    out, pinned_new = pipeline._read_back(canvas)
    del canvas
    gc.collect()
    assert pinned_new == 0 and not any(asked)
    assert out.dtype == np.uint8 and out.shape == shape
    assert out.flags.c_contiguous and out.flags.writeable
    np.testing.assert_array_equal(out, want)


def _cuda_job(entry, keep_on_device=False):
    """One job of :func:`_items` on the card through ``pipeline.run`` or
    ``pipeline.run_overlapped``, and the records of its interval."""
    items = _items()
    plan = solve([ImageSpec(a.shape[1], a.shape[0], o) for a, o in items],
                 _OPTS)
    cfg = RuntimeConfig(device="cuda")
    imgs = [a for a, _ in items]
    if entry == "run":
        return _window(lambda: pipeline.run(plan, imgs, cfg,
                                            keep_on_device=keep_on_device))
    return _window(lambda: pipeline.run_overlapped(
        plan, [(lambda a=a: a) for a in imgs], cfg,
        keep_on_device=keep_on_device))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["run_overlapped", "run"])
def test_cuda_readback_reuses_one_pinned_block(entry):
    """Two jobs of one shape, the first canvas dropped in between: both
    land in pinned host memory, the second in the block the first gave
    back (the pool does not grow), and the bytes equal the pageable
    readback of the same device canvas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CPU canvas is never pinned")
    (first, _), _ = _cuda_job(entry)
    assert first.base.is_pinned()
    del first
    gc.collect()
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    (out, m), records = _cuda_job(entry)
    after = torch.cuda.host_memory_stats()["num_host_alloc"]
    assert after == before
    assert out.base.is_pinned()
    assert out.flags.c_contiguous and out.flags.writeable
    if entry == "run_overlapped":
        (readback,) = [r for r in records if r.name == "readback"
                       and r.thread == threading.get_ident()]
        assert readback.counts["pinned_new"] == 0
    (canvas, _), _ = _cuda_job(entry, keep_on_device=True)
    assert isinstance(canvas, torch.Tensor) and canvas.is_cuda
    pageable = canvas.cpu().numpy()
    pinned, _ = pipeline._read_back(canvas)
    np.testing.assert_array_equal(pinned, pageable)
    np.testing.assert_array_equal(out, pageable)
    print(f"{entry}: {m.strategy}, canvas {out.shape}, readback "
          f"{m.readback_s * 1e3:.3f} ms, num_host_alloc over the second "
          f"job {before} -> {after}")


def test_overfilled_ring_reports_the_drop(monkeypatch):
    monkeypatch.setattr(spans, "RING", spans.Ring(8, 2))
    marks = []
    for _ in range(20):
        with spans.span("test.fill") as s:
            pass
        marks.append((s.start_ns, s.end_ns))
    held, dropped = spans.snapshot(*marks[0])
    assert dropped and held == []
    held, dropped = spans.snapshot(marks[-1][0], marks[-1][1])
    assert not dropped and [r.span for r in held] == [s.id]
    seqs = [r.seq for r in spans.RING.snapshot(0, marks[-1][1])[0]]
    assert seqs == sorted(seqs) and seqs[-1] == 19 and len(seqs) <= 8


def test_ring_reports_every_drop_under_contention(monkeypatch):
    """More threads than cores, a short switch interval and a small ring:
    every span missing from a snapshot of its own interval is reported as
    dropped, and no two records share a sequence number."""
    monkeypatch.setattr(spans, "RING", spans.Ring(64, 16))
    n_threads, n_spans = 16, 300
    done = [[] for _ in range(n_threads)]

    def work(k):
        for _ in range(n_spans):
            with spans.span("test.stress", job=k + 1) as s:
                pass
            done[k].append((s.id, s.start_ns, s.end_ns))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sum(map(len, done)) == n_threads * n_spans
    held, _ = spans.RING.snapshot(0, time.perf_counter_ns())
    assert len({r.seq for r in held}) == len(held) <= 64
    for span_id, a, b in (x for d in done for x in d):
        got, dropped = spans.RING.snapshot(a, b)
        assert dropped or span_id in {r.span for r in got}
