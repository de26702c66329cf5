"""The benchmark's arithmetic: percentiles, the rate with its in-flight
tail, the device trace's reduction and the roofline's byte count."""

import statistics

import pytest

from stitchbench import deploy, harness, roofline
from stitchbench.harness import Cell
from stitchbench.reference.stitch import is_copy


def _rec(times, t0=0.0):
    return {"t0": t0, "jobs": [{"start": a, "end": b, "ok": ok}
                               for a, b, ok in times]}


def test_percentiles_interpolate_between_order_statistics():
    vals = [float(v) for v in range(1, 101)]          # 1..100
    assert harness.percentile(vals, 50) == 50.5
    assert harness.percentile(vals, 90) == pytest.approx(90.1)
    assert harness.percentile(vals, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert harness.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        harness.percentile([], 50)
    assert harness.percentile(vals, 90) == statistics.quantiles(
        vals, n=10, method="inclusive")[8]


def test_job_ms_counts_completed_jobs_only():
    rec = _rec([(0.0, 0.25, True), (0.25, 0.75, True), (0.75, 0.8, False)])
    assert harness.job_ms(rec) == [250.0, 500.0]


def test_rate_counts_the_in_flight_tail_with_its_time():
    # window [0, 10): 40 jobs of 0.3 s one after another from 0, the last
    # started at 9.9 and ending at 10.2 -> 34 jobs over 10.2 s, not 33 whole
    # ones over 9.9 s and not 34 over 10 s
    jobs = [(0.3 * k, 0.3 * (k + 1), True) for k in range(33)]
    jobs.append((9.9, 10.2, True))
    rec = _rec(jobs)
    assert harness.rate(rec) == pytest.approx(34 / 10.2)
    # a failed job is not completed work
    rec["jobs"].append({"start": 9.95, "end": 10.5, "ok": False})
    assert harness.rate(rec) == pytest.approx(34 / 10.2)
    assert harness.rate(_rec([])) is None


def test_mean_ms_reads_stitch_metrics():
    rec = {"jobs": [{"ok": True, "m": {"readback_s": 0.1}},
                    {"ok": True, "m": {"readback_s": 0.3}},
                    {"ok": False}]}
    assert harness.mean_ms(rec, "readback_s") == pytest.approx(200.0)


def test_reduce_device_union_kernels_and_named_gaps():
    ms = 1_000_000
    events = [("resize_place_kernel", 10 * ms, 20 * ms),
              ("Memcpy HtoD (Pageable -> Device)", 15 * ms, 30 * ms),
              ("Memset (Device)", 50 * ms, 51 * ms),
              ("resize_place_kernel", 60 * ms, 70 * ms),
              ("Memcpy DtoD (Device -> Device)", 65 * ms, 68 * ms),
              ("Memcpy DtoH (Device -> Pageable)", 95 * ms, 130 * ms)]
    spans = [("stitch", 0, 40 * ms), ("wait", 40 * ms, 100 * ms)]
    t = harness.reduce_device(events, 0, 100 * ms, spans)
    # busy: 10-30, 50-51, 60-70, 95-100
    assert t["busy_s"] == pytest.approx(0.036)
    assert t["window_s"] == pytest.approx(0.1)
    # work: both kernels, the set and the device-to-device copy; the host
    # transfers are not work on the device
    assert t["work_s"] == pytest.approx(0.024)
    assert t["device_ops"][0] == ["resize_place_kernel", pytest.approx(0.02)]
    assert t["idle_gaps"][0] == ["wait", pytest.approx(0.025)]   # 70-95
    assert t["idle_gaps"][1] == ["stitch", pytest.approx(0.020)]  # 30-50
    assert [g[0] for g in t["idle_gaps"]] == ["wait", "stitch", "stitch",
                                              "wait"]


def test_idle_share_and_roofline_readers():
    cell = Cell("phone12mp_exif.arrays")
    rec = {"jobs": [{"ok": True}] * 4, "job_bytes": 3_350_000,
           "device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"busy_s": 0.25, "window_s": 1.0, "work_s": 0.008}}
    assert cell.reader("idle_share.job").read(rec) == pytest.approx(75.0)
    # 4 jobs x 3.35 MB at 3.35 TB/s = 4 us, over 8 ms of device work
    assert cell.reader("kernel_roofline.job").read(rec) == pytest.approx(0.05)
    rec["device_kind"] = "some other card"
    assert cell.reader("kernel_roofline.job").read(rec) is None
    rec["trace"] = None
    assert cell.reader("idle_share.job").read(rec) is None


def test_server_readers():
    cell = Cell("serve64_1080p.closed64")
    rec = {"server": {"jobs": 128, "batches": 4, "queue_wait_s": 12.8,
                      "flush_s": 8.0, "stack_s": 5.0, "failed": 0}}
    assert cell.reader("stack_ms.serve").read(rec) == 1250.0
    assert cell.reader("flush_ms.serve").read(rec) == 750.0
    assert cell.reader("queue_wait_ms.serve").read(rec) == 100.0
    assert cell.reader("batch_jobs.serve").read(rec) == 32.0
    rec["server"]["batches"] = 0
    assert cell.reader("batch_jobs.serve").read(rec) is None


def test_roofline_bytes_of_config5_flush_match_the_smoke_figure():
    # chip_smoke.py phase 10: kernel #2 at config 5, B = 64, bound 1.1358 ms
    cfg = Cell("serve64_1080p.closed64").config
    nbytes = 64 * roofline.resample_bytes(
        deploy.layout(cfg, deploy.shapes(cfg)))
    bound_ms = roofline.bound_s(nbytes, "NVIDIA H100 80GB HBM3") * 1e3
    assert bound_ms == pytest.approx(1.1358, abs=5e-5)


def test_roofline_bytes_of_config4_exif_within_the_chunked_count():
    # chip_smoke.py phase 15 counted kernel #3 chunk by chunk (45 chunks):
    # 0.0841 ms; read once over the plan, the footprint can only be less
    cfg = Cell("phone12mp_exif.arrays").config
    lay = deploy.layout(cfg, deploy.shapes(cfg))
    bound_ms = roofline.bound_s(roofline.resample_bytes(lay),
                                "NVIDIA H100 80GB HBM3") * 1e3
    assert 0.06 < bound_ms <= 0.0841
    assert sum(not is_copy(r) for r in lay.rects) == 5


def test_job_bytes_count_copies_and_background_hand_worked():
    # two 4x4 sources stacked vertically at width 4, gap 2: both copy, so
    # no resampling; each copy is read and written once (2 x 48 bytes),
    # the 2x4 gap of background written once (24 bytes)
    lay = deploy.layout({"options": {"direction": "vertical", "mode": "min",
                                     "gap": 2}}, [(4, 4, 1), (4, 4, 3)])
    assert (lay.canvas_w, lay.canvas_h) == (4, 10)
    assert all(is_copy(r) for r in lay.rects)
    assert roofline.resample_bytes(lay) == 0
    assert roofline.job_bytes(lay) == 2 * 2 * 48 + 24
    # an 8x8 source brought down to width 4 resamples: its bytes are the
    # tap footprint and the 4x4 rect written, and the gap grows with it
    lay = deploy.layout({"options": {"direction": "vertical", "mode": "min",
                                     "gap": 2}}, [(4, 4, 1), (8, 8, 1)])
    res = roofline.resample_bytes(lay)
    assert res == (8 * 8 + 4 * 4) * 3
    assert roofline.job_bytes(lay) == res + 2 * 48 + 24


def test_job_bytes_of_config5_and_config4_exif():
    cfg = Cell("serve64_1080p.closed64").config
    lay = deploy.layout(cfg, deploy.shapes(cfg))
    copies = [r for r in lay.rects if is_copy(r)]
    assert len(copies) == 1
    area = sum((r.row_span[1] - r.row_span[0]) * (r.col_span[1]
                                                  - r.col_span[0])
               for r in lay.rects)
    assert roofline.job_bytes(lay) == (
        roofline.resample_bytes(lay) + 2 * 1024 * 768 * 3
        + (lay.canvas_w * lay.canvas_h - area) * 3)
    cfg = Cell("phone12mp_exif.arrays").config
    lay = deploy.layout(cfg, deploy.shapes(cfg))
    # four 3000x4000 rotated copies, read and written once; 8 gaps of 4
    # rows of background
    assert roofline.job_bytes(lay) == (roofline.resample_bytes(lay)
                                       + 4 * 2 * 3000 * 4000 * 3
                                       + 8 * 4 * 3000 * 3)


def test_reservoir_keeps_k_per_stratum_drawn_from_the_seed():
    def draw(seed):
        r = harness.Reservoir(1, seed, keep=lambda v: v * 10)
        for k in range(200):
            r.offer(k, k, stratum=k % 4)
        return r.items
    items = draw(7)
    assert [k % 4 for k, _ in items] == [0, 1, 2, 3]
    assert all(v == 10 * k for k, v in items)
    assert draw(7) == items and draw(8) != items
    r = harness.Reservoir(2, 3)
    for k in range(5):
        r.offer(k, str(k))
    assert len(r.items) == 2


def test_batch_position_of_a_flush_view():
    import numpy as np

    host = np.zeros((5, 3, 4, 3), np.uint8)
    assert [harness.batch_position(host[i]) for i in range(5)] == list(
        range(5))
    assert harness.batch_position(host[2].copy()) is None
    assert harness.batch_position(np.zeros((3, 4, 3), np.uint8)) is None
    assert harness.batch_position(host[1][1:]) is None
