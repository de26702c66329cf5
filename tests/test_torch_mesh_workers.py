"""The jobs mesh over distinct devices, whose cards a flush serves at once:
each card uploads, draws, syncs and reads back its shard on its own worker
thread (``parallel.batch``).  Here on a mesh of four distinct ``cpu``
devices (``cpu:0`` .. ``cpu:3``), with the plain engine, at config 5's
shapes divided by 16 (the four-card benchmark cell's configuration).

Checked: the canvases equal the one-device server's and those of a mesh
that repeats one device (served on the calling thread), byte for byte; the
``batch.*`` spans land whole from the workers, as direct children of their
``serve.flush``; a fault in one card's unit fails only the poisoned job,
and no unit is still running when the split-retry starts; one worker a
card, however many flushes and ``BatchedStitch`` objects; none where the
shards lie on one device."""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch import RuntimeConfig, StitchServer
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.parallel import batch
from imagestitching_tpu_torch.parallel.mesh import make_mesh
from imagestitching_tpu_torch.runtime import spans
from stitchbench import deploy, harness

CONFIG = harness.load_json(os.path.join(
    harness.ROOT, "stitchbench", "configs", "serve64_1080p_mesh4.json"))
SHAPES = deploy.shapes(CONFIG, 16)
ORIENT = [o for _, _, o in SHAPES]
OPTIONS = deploy.options(CONFIG)
CARDS = [f"cpu:{k}" for k in range(4)]
BATCH = ("batch.h2d", "batch.draw", "batch.sync", "batch.readback")
SIZES = [5, 13, 16]
T = 120                                 # seconds any future may take


def _jobs(n, seed=0):
    rng = np.random.default_rng(2200 + 100 * seed + n)
    return [[rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in SHAPES]
            for _ in range(n)]


def _server(devices, max_batch):
    mesh = None if devices is None else make_mesh(devices=devices)
    config = dataclasses.replace(RuntimeConfig(device="cpu"), mesh=mesh)
    return StitchServer(max_batch=max_batch, max_wait_s=30.0, engine="torch",
                        use_mesh=mesh is not None, config=config)


def _serve(jobs, devices):
    """One flush of every job: the canvases in submission order, the
    window's records and the server thread's id."""
    t0 = time.perf_counter_ns()
    with _server(devices, len(jobs)) as server:
        futs = [server.submit(imgs, OPTIONS, orientations=ORIENT)
                for imgs in jobs]
        outs = [f.result(timeout=T) for f in futs]
        assert server.stats()["batches"] == 1
        worker = server._thread.ident
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    return outs, records, worker


def _card_threads():
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("batch.card cpu:"))


@pytest.fixture(scope="module", params=SIZES, ids=[f"b{n}" for n in SIZES])
def served(request):
    jobs = _jobs(request.param)
    return (jobs, _serve(jobs, CARDS), _serve(jobs, ["cpu"] * 4),
            _serve(jobs, None))


def test_distinct_cards_equal_one_device_and_a_repeated_device(served):
    """Byte for byte, padding rows dropped: the four workers' canvases
    equal the one-device server's and the serial mesh's."""
    jobs, (outs, *_), (serial, *_), (one, *_) = served
    n, padded = len(jobs), -(-len(jobs) // 4) * 4
    assert len(outs) == n
    assert {out.base.shape[0] for out in outs} == {padded}
    for got, a, b in zip(outs, serial, one):
        assert got.dtype == a.dtype == b.dtype and got.shape == a.shape
        assert got.tobytes() == a.tobytes() == b.tobytes()


def test_card_spans_are_children_of_their_flush(served):
    """Each card's upload, draw, sync and readback land whole, as direct
    children of the flush with its ``card``, from that card's own worker
    (never the server's thread); one ``batch.sync`` a card; the flush
    counts four cards."""
    jobs, (_, records, server), *_ = served
    (flush,) = [r for r in records if r.name == "serve.flush"]
    n = len(jobs)
    assert flush.counts == {"jobs": n, "pad_jobs": -n % 4, "cards": 4}
    batch_recs = [r for r in records if r.name in BATCH]
    assert all(r.parent == flush.span and r.job == flush.job
               for r in batch_recs)
    assert all(set(r.counts) == {"card"} for r in batch_recs)
    assert sorted((r.name, r.counts["card"]) for r in batch_recs) == sorted(
        (name, k) for name in BATCH for k in range(4))
    assert all(flush.start_ns <= r.start_ns <= r.end_ns <= flush.end_ns
               for r in batch_recs)
    threads = {}
    for r in batch_recs:
        threads.setdefault(r.counts["card"], set()).add(r.thread)
    assert all(len(t) == 1 for t in threads.values())
    assert len(set.union(*threads.values())) == 4
    assert server not in set.union(*threads.values())
    for k in range(4):
        seq = [r.name for r in batch_recs if r.counts["card"] == k]
        assert seq == list(BATCH)


def test_the_host_array_is_taken_once_on_the_server_thread(served):
    """A flush takes its host array once, before any card's unit: one
    ``batch.host`` span, a direct child of the flush on the server's
    thread, counting its pinned blocks (none on the CPU) and no card."""
    _, (_, records, server), *_ = served
    (flush,) = [r for r in records if r.name == "serve.flush"]
    (host,) = [r for r in records if r.name == "batch.host"]
    assert host.parent == flush.span and host.thread == server
    assert host.counts == {"pinned_new": 0}
    assert all(host.end_ns <= r.start_ns for r in records
               if r.name in BATCH)


def test_repeated_device_keeps_the_serial_schedule(served):
    """A mesh that repeats one device counts one card and runs on the
    server's thread: every shard enqueued, one sync, every readback."""
    _, _, (_, records, server), _ = served
    (flush,) = [r for r in records if r.name == "serve.flush"]
    assert flush.counts["cards"] == 1
    recs = [r for r in records if r.name in BATCH]
    assert {r.thread for r in recs} == {server}
    assert [(r.name, r.counts["card"]) for r in recs] == (
        [(name, k) for k in range(4) for name in BATCH[:2]]
        + [("batch.sync", 0)] + [("batch.readback", k) for k in range(4)])


@pytest.mark.parametrize("poisoned", [0, 6], ids=["card0", "card3"])
def test_a_card_fault_fails_only_its_job_after_every_card_stops(
        poisoned, monkeypatch):
    """A fault in one card's unit, while the other cards are still at
    work, fails the flush only once every unit has stopped; the
    split-retry then fails only the poisoned job, and every other job's
    canvas is the one-device server's."""
    jobs = _jobs(7, seed=1)
    poison = jobs[poisoned][0]
    running, seen = [0], []
    lock = threading.Lock()
    serve_card = batch.BatchedStitch._serve_card
    shard = batch.BatchedStitch._shard

    def counted(self, *a):
        with lock:
            running[0] += 1
        try:
            return serve_card(self, *a)
        finally:
            with lock:
                running[0] -= 1

    def faulty(self, card, slots):
        if any(arr.data_ptr() == poison.ctypes.data for arr in slots[0]):
            raise RuntimeError("planted card fault")
        time.sleep(0.05)            # the healthy cards finish later
        return shard(self, card, slots)

    flush_started = StitchServer._flush_started

    def retry(self, jobs_):
        with lock:
            seen.append(running[0])
        return flush_started(self, jobs_)

    monkeypatch.setattr(batch.BatchedStitch, "_serve_card", counted)
    monkeypatch.setattr(batch.BatchedStitch, "_shard", faulty)
    monkeypatch.setattr(StitchServer, "_flush_started", retry)
    with _server(CARDS, len(jobs)) as server:
        futs = [server.submit(imgs, OPTIONS, orientations=ORIENT)
                for imgs in jobs]
        done = [(f.exception(timeout=T), None) if f.exception(timeout=T)
                else (None, f.result()) for f in futs]
        stats = server.stats()
    assert len(seen) > 1 and seen == [0] * len(seen)
    assert running == [0]
    assert stats["failed"] == 1
    monkeypatch.undo()
    want, *_ = _serve(jobs, None)
    for i, (err, out) in enumerate(done):
        if i == poisoned:
            assert isinstance(err, RuntimeError) \
                and "planted card fault" in str(err)
        else:
            assert err is None and out.tobytes() == want[i].tobytes()


def test_one_worker_a_card_across_flushes_and_objects():
    """Many calls of several ``BatchedStitch`` objects of different batch
    sizes, on the mesh of four distinct devices, under a short switch
    interval: four worker threads, one a card, and each call's spans land
    whole; a server's warm-up starts them too."""
    plan = solve([ImageSpec(24, 16), ImageSpec(16, 20)], OPTIONS,
                 RuntimeConfig().limits)
    mesh = make_mesh(devices=CARDS)
    rng = np.random.default_rng(22)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for b in (4, 8, 12, 8, 4, 16):
            bs = batch.BatchedStitch(plan, b, engine="torch", mesh=mesh)
            bs.warm()
            slots = [[rng.integers(0, 256, (p.raw_h, p.raw_w, 3), np.uint8)
                      for _ in range(b - 1)] for p in plan.placements]
            with spans.span("test.call") as call:
                got = bs(slots)
            records, _ = spans.snapshot(call.start_ns, call.end_ns)
            kids = [r for r in records if r.parent == call.id]
            assert sorted((r.name, r.counts["card"]) for r in kids
                          if r.name in BATCH) == sorted(
                (name, k) for name in BATCH for k in range(4))
            assert [r.name for r in kids if r.name not in BATCH] == [
                "batch.host"]
            want = batch.BatchedStitch(plan, b, engine="torch",
                                       device="cpu")(slots)
            assert got.tobytes() == want.tobytes()
            assert _card_threads() == [f"batch.card cpu:{k}_0"
                                       for k in range(4)]
    finally:
        sys.setswitchinterval(old)
    with _server(CARDS, 8) as server:
        server.warmup([(h, w) for w, h, _ in SHAPES], OPTIONS,
                      orientations=ORIENT, batch_sizes=[8])
    assert _card_threads() == [f"batch.card cpu:{k}_0" for k in range(4)]


@pytest.mark.parametrize("devices", [None, ["cpu"] * 4, ["cpu:7"] * 4],
                         ids=["one-device", "cpu-x4", "cpu7-x4"])
def test_one_card_starts_no_worker(devices):
    """Where the shards lie on one device the call runs on the calling
    thread: it starts no thread and records every span there."""
    plan = solve([ImageSpec(24, 16), ImageSpec(16, 20)], OPTIONS,
                 RuntimeConfig().limits)
    kw = dict(device="cpu") if devices is None else dict(
        mesh=make_mesh(devices=devices))
    bs = batch.BatchedStitch(plan, 8, engine="torch", **kw)
    assert bs.cards == 1
    before = set(threading.enumerate())
    bs.warm()
    with spans.span("test.call") as call:
        bs([[np.zeros((p.raw_h, p.raw_w, 3), np.uint8)] * 5
            for p in plan.placements])
    assert set(threading.enumerate()) == before
    assert torch.device(devices[0] if devices else "cpu") not in batch._workers
    records, _ = spans.snapshot(call.start_ns, call.end_ns)
    kids = [r for r in records if r.parent == call.id]
    assert kids and {r.thread for r in kids} == {threading.get_ident()}
