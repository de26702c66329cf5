"""Closed loop into ``StitchServer``: each client submits one job (its
arrays) with ``StitchServer.submit`` and submits again when the future's
result is back.

Parameters (``workloads/<cell>.json``):

* ``clients``: concurrent clients (threads);
* ``pool_jobs``: distinct jobs of uniform noise made on the card from the
  seed; client ``c``'s ``k``-th job is ``(c + k) % pool_jobs``, so
  batch-mates change from round to round;
* ``warm_batches``: the batch sizes ``StitchServer.warmup`` runs in
  set-up;
* ``check_jobs``: the finished jobs sampled from the seed for the
  reference: one at each position within a flush (a canvas's index in its
  flush's host array), so a run covers every position up to its largest
  batch; where a result is no view of a flush's array, one in each of
  ``check_jobs`` classes of finishing order.  A sampled canvas is copied,
  so that it holds no flush's array.

The server's settings (``StitchServer``'s keyword arguments) and budget
are the configuration's.  The server's ``stats()`` before and after the
window go into the run's record.
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from stitchbench import deploy, inputs
from stitchbench.harness import Reservoir, batch_position

STATS = ("jobs", "batches", "failed", "queue_wait_s", "flush_s", "stack_s")


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
        self.server = None

    def make_inputs(self) -> None:
        self.stacks = inputs.noise_stacks(self.shapes,
                                          int(self.p["pool_jobs"]),
                                          self.seed, self.device)

    def warm(self) -> None:
        n = len(self.stacks[0])
        self.orient = [o for _, _, o in self.shapes]
        self.options = deploy.options(self.cell.config)
        self.server = deploy.server(self.cell.config, str(self.device),
                                    self.rehearsal)
        self.server.warmup([(h, w) for w, h, _ in self.shapes], self.options,
                           orientations=self.orient,
                           batch_sizes=self.p.get("warm_batches", [n]))

    def _job(self, idx):
        return [s[idx] for s in self.stacks]

    def window(self, seconds: float) -> dict:
        n = len(self.stacks[0])
        clients, strata = int(self.p["clients"]), int(self.p["check_jobs"])
        self.sample = Reservoir(1, self.seed, keep=np.copy)
        order = itertools.count()
        jobs, go = [], threading.Event()
        span, server = self.spans.span, self.server

        def client(c):
            go.wait()
            k = 0
            while time.perf_counter() < t1:
                idx = (c + k) % n
                t_s = time.perf_counter()
                try:
                    with span("submit"):
                        fut = server.submit(self._job(idx), self.options,
                                            orientations=self.orient)
                    with span("wait"):
                        out = fut.result(timeout=300)
                except Exception as e:  # noqa: BLE001 — counted as failed
                    jobs.append({"start": t_s, "end": time.perf_counter(),
                                 "ok": False, "error": repr(e)})
                else:
                    jobs.append({"start": t_s, "end": time.perf_counter(),
                                 "ok": True})
                    pos = batch_position(out)
                    self.sample.offer(idx, out, pos if pos is not None
                                      else ("order", next(order) % strata))
                    del out
                k += 1

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        before = server.stats()
        t0 = time.perf_counter()
        t1 = t0 + seconds
        go.set()
        for t in threads:
            t.join()
        t_end = time.perf_counter()
        after = server.stats()
        return {"t0": t0, "t_end": t_end, "jobs": jobs,
                "server": {k: after[k] - before[k] for k in STATS}}

    def release(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None

    def sources(self, idx):
        """Pool job ``idx``'s raw sources and their shapes."""
        return self._job(idx), self.shapes

    def close(self) -> None:
        self.release()
