"""Closed loop into ``imagestitching_tpu_torch.stitch``: one caller calls
``stitch(items, options=..., config=..., return_metrics=True)`` and calls
again when the host canvas is back.

Parameters (``workloads/<cell>.json``):

* ``inputs``: ``"arrays"`` -- nine ``(uint8 array, orientation)`` items of
  uniform noise made on the card; ``"jpeg"`` -- nine JPEG paths (quality
  95, EXIF orientation tag, photo-like pixels) written under ``TMPDIR`` in
  set-up;
* ``pool_jobs``: distinct jobs made from the seed; the calls cycle through
  them, the warm-up takes the first and the window starts after it, so a
  file set returns only after every other has been read;
* ``check_jobs``: finished jobs sampled from the seed for the reference.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from stitchbench import deploy, inputs
from stitchbench.harness import Reservoir


class Traffic:
    """What ``run.py`` drives, in order: ``make_inputs()``, ``warm()``
    (both set-up), ``window(seconds)`` (the record: ``t0``, ``t_end``,
    ``jobs``), ``release()``, then the reference reads ``sample`` and
    ``sources(idx)``; ``close()`` removes what set-up wrote."""

    def __init__(self, cell, seed: int, device, rehearsal: bool, spans):
        self.cell, self.seed, self.device = cell, seed, device
        self.spans = spans
        p = dict(cell.params)
        if rehearsal:
            p.update(p.get("rehearsal", {}))
        self.p = p
        self.shapes = deploy.shapes(cell.config, p.get("scale", 1))
        self.rehearsal = rehearsal
        self.tmp = None

    # ------------------------------------------------------------ set-up

    def make_inputs(self) -> None:
        p, dev = self.p, self.device
        n = int(p["pool_jobs"])
        if p["inputs"] == "arrays":
            stacks = inputs.noise_stacks(self.shapes, n, self.seed, dev)
            self.pool = [[(s[j], o) for s, (_, _, o) in zip(stacks,
                                                             self.shapes)]
                         for j in range(n)]
        elif p["inputs"] == "jpeg":
            self.tmp = tempfile.mkdtemp(prefix="stitchbench-")
            self.pool = []
            for j in range(n):
                d = os.path.join(self.tmp, f"job{j}")
                os.mkdir(d)
                seeds = [(self.seed * 1_000_003 + 97 * j + k) % (1 << 62)
                         for k in range(len(self.shapes))]
                self.pool.append(inputs.write_jpegs(d, self.shapes, seeds,
                                                    dev))
        else:
            raise ValueError(f"unknown inputs {p['inputs']!r}")

    def warm(self) -> None:
        import imagestitching_tpu_torch as itt

        self.stitch = itt.stitch
        self.options = deploy.options(self.cell.config)
        self.config = deploy.runtime(self.cell.config, str(self.device),
                                     self.rehearsal)
        self._call(self.pool[0])

    def _call(self, items):
        return self.stitch(items, options=self.options, config=self.config,
                           return_metrics=True)

    # ------------------------------------------------------------ window

    def window(self, seconds: float) -> dict:
        n = len(self.pool)
        self.sample = Reservoir(int(self.p["check_jobs"]), self.seed)
        jobs, span = [], self.spans.span
        t0 = time.perf_counter()
        t1 = t0 + seconds
        k = 0
        while time.perf_counter() < t1:
            idx = (1 + k) % n
            t_s = time.perf_counter()
            try:
                with span("stitch"):
                    out, m = self._call(self.pool[idx])
            except Exception as e:  # noqa: BLE001 — counted as failed
                jobs.append({"start": t_s, "end": time.perf_counter(),
                             "ok": False, "error": repr(e)})
            else:
                jobs.append({"start": t_s, "end": time.perf_counter(),
                             "ok": True,
                             "m": {"prepare_s": m.prepare_s,
                                   "stage_wait_s": m.stage_wait_s,
                                   "readback_s": m.readback_s,
                                   "strategy": m.strategy}})
                self.sample.offer(idx, out)
                del out
            k += 1
        return {"t0": t0, "t_end": time.perf_counter(), "jobs": jobs}

    def release(self) -> None:
        """Nothing to free: ``stitch`` keeps no state for its caller."""

    def sources(self, idx):
        """The reference's own view of pool job ``idx``: raw pixels and
        orientations (for files, decoded here by Pillow)."""
        items = self.pool[idx]
        if self.p["inputs"] == "jpeg":
            items = [inputs.decode_jpeg(path) for path in items]
        return [a for a, _ in items], [(a.shape[1], a.shape[0], o)
                                       for a, o in items]

    def close(self) -> None:
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)
