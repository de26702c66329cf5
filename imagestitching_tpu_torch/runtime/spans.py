"""Spans and counters inside the port: one process-wide ring of timed records.

A span is one named interval of work on one thread: its name, the job it
belongs to, its own id, its parent's id (0 for a root), the thread that
recorded it, its start and end in ``time.perf_counter_ns()`` and an
optional small dict of counts (the pages a readback made resident, the
pinned blocks it allocated, a flush's jobs and cards).  The clock is the one that ``stitchbench``'s
device trace is anchored to, so program spans line up with the kernels and
copies of a ``torch.profiler`` trace.

Recording is always on: a span costs two clock reads and one append, with
no lock (``deque.append`` is atomic), into :data:`RING`.  Where a phase
follows another on one thread, it starts at the reading that closed the
one before (``start_ns=``), so one boundary is one clock read; the
pipeline's and the server's totals (``StitchMetrics``, ``stats()``) are
sums of the same readings.  While a ``torch.profiler`` records the calling
thread, each span also opens a profiler range of its name (a host op), so a
Chrome trace shows the program's phases above the device work; otherwise
no range is opened.  A profiler records only the thread that started it.

    >>> with span("stitch", job=new_job()) as root:
    ...     with span("readback", count_pages=True):
    ...         ...
    >>> records, dropped = snapshot(root.start_ns, root.end_ns)

Names and what reads them are listed in PERF.md (section 3).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
from threading import get_ident
from time import perf_counter_ns
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler


def _profiler_range(name: str):
    """A profiler range of the span's name.  Not ``record_function``: a
    user annotation is copied onto the device's timeline
    (``gpu_user_annotation``) over the kernels and copies it launched,
    where a reader of device events would count it as device work; this
    range is a host op, as the traces of compiled kernels use.  The class
    is private to torch, so it is looked up only while a profiler runs."""
    try:
        fast = torch._C._profiler._RecordFunctionFast
    except AttributeError as e:
        raise RuntimeError(
            "spans: this torch has no torch._C._profiler._RecordFunctionFast"
            f" (torch {torch.__version__}); span ranges under a profiler "
            "need another host-op range") from e
    return fast(name)


#: Records the ring holds: the server cell's 51 s window records about
#: 4,600 and the phone cell's about 15,600 (58 a job), so this holds twice
#: the larger with room for a job twice as fast.
CAPACITY = 1 << 16

class Record(NamedTuple):
    seq: int            # the ring's append order
    name: str
    job: int            # 0: no job (a server flush, a warm-up)
    span: int
    parent: int         # 0: a root
    thread: int         # threading.get_ident() of the recording thread
    start_ns: int
    end_ns: int
    counts: Optional[Dict[str, int]]


class Ring:
    """A bounded store of :class:`Record`: appended to without a lock; once
    it holds more than ``capacity`` records, the oldest are dropped under a
    lock in one batch down to ``capacity - trim``, and the latest end among
    the dropped is kept, so that :meth:`snapshot` can say whether an
    interval lost any."""

    def __init__(self, capacity: int, trim: int):
        self.capacity, self.trim = capacity, trim
        self._records: collections.deque = collections.deque()
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._dropped_end_ns = -1

    def append(self, name: str, job: int, span_id: int, parent: int,
               start_ns: int, end_ns: int,
               counts: Optional[Dict[str, int]]) -> None:
        # a plain tuple here; snapshot() makes the Records
        records = self._records
        records.append((next(self._seq), name, job, span_id, parent,
                        get_ident(), start_ns, end_ns, counts))
        if len(records) > self.capacity:
            self._drop_oldest()

    def _drop_oldest(self) -> None:
        with self._lock:
            while len(self._records) > self.capacity - self.trim:
                end_ns = self._records.popleft()[7]
                if end_ns > self._dropped_end_ns:
                    self._dropped_end_ns = end_ns

    def snapshot(self, start_ns: int, end_ns: int
                 ) -> Tuple[List[Record], bool]:
        """The records that meet [start_ns, end_ns], in append order, and
        whether a record that met it was dropped (a dropped record ended
        at or after ``start_ns``)."""
        with self._lock:
            held = list(self._records)
            dropped = self._dropped_end_ns >= start_ns
        return ([Record._make(r) for r in held
                 if r[6] <= end_ns and r[7] >= start_ns], dropped)


RING = Ring(CAPACITY, CAPACITY // 16)

_span_ids = itertools.count(1)
_job_ids = itertools.count(1)


class Context(NamedTuple):
    """What a span opened on another thread needs from its parent."""
    job: int
    span: int


class _Current(threading.local):
    ctx = (0, 0)            # the thread's job and innermost open span


_current = _Current()


def new_job() -> int:
    """A fresh job id for a root span."""
    return next(_job_ids)


def current() -> Context:
    """The calling thread's job and innermost open span (0, 0 outside any
    span), to hand to work on another thread."""
    return Context(*_current.ctx)


@contextlib.contextmanager
def within(ctx: Context) -> Iterator[None]:
    """Open the calling thread's spans as children of ``ctx``, a
    :func:`current` read on the thread that handed this one its work, until
    the block ends.  On the thread that read ``ctx`` it changes nothing."""
    outer = _current.ctx
    _current.ctx = (ctx.job, ctx.span)
    try:
        yield
    finally:
        _current.ctx = outer


def _profiling() -> bool:
    # the module flag is one attribute read; the thread's own state is
    # asked only while some profiler runs
    return (_autograd_profiler._is_profiler_enabled
            and torch._C._autograd._profiler_enabled())


class span:
    """A span on the calling thread, used as a context manager.

    Without ``job`` it belongs to the thread's current job and its parent
    is the thread's innermost open span; with ``job`` it is a root unless
    ``parent`` is given too.  ``start_ns`` starts it at a reading already
    taken (the end of the phase before).  With ``count_pages`` its record
    counts ``new_pages``, the growth of the process's resident pages over
    the span (:func:`resident_pages`), beside any counts the body set in
    ``counts``.  A span closes on every exit path."""

    __slots__ = ("name", "job", "parent", "id", "start_ns", "end_ns",
                 "counts", "_outer", "_range", "_count_pages", "_pages")

    def __init__(self, name: str, *, job: Optional[int] = None,
                 parent: Optional[int] = None,
                 start_ns: Optional[int] = None, count_pages: bool = False):
        self.name = name
        self.job, self.parent, self.start_ns = job, parent, start_ns
        self.end_ns: Optional[int] = None
        self.counts: Optional[Dict[str, int]] = None
        self._count_pages = count_pages

    def __enter__(self) -> "span":
        self._range = None
        if _profiling():
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        self._pages = resident_pages() if self._count_pages else None
        self._outer = outer = _current.ctx
        if self.job is None:
            self.job = outer[0]
            if self.parent is None:
                self.parent = outer[1]
        elif self.parent is None:
            self.parent = 0
        self.id = next(_span_ids)
        _current.ctx = (self.job, self.id)
        if self.start_ns is None:
            self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        counts = self.counts
        if self._pages is not None:
            pages = resident_pages()
            if pages is not None:
                counts = {**(counts or {}), "new_pages": pages - self._pages}
        _current.ctx = self._outer
        RING.append(self.name, self.job, self.id, self.parent,
                    self.start_ns, self.end_ns, counts)


def record(name: str, start_ns: int, end_ns: int, *, job: int,
           parent: int) -> None:
    """Record a span from two readings already taken (a wait that began on
    another thread)."""
    RING.append(name, job, next(_span_ids), parent, start_ns, end_ns, None)


def resident_pages() -> Optional[int]:
    """The process's resident pages (``/proc/self/statm``), or None where
    the host has no such file.  Their growth over a span counts the pages
    first touched in it, each one minor fault where pages are 4 KiB.  A
    sandboxed kernel such as gVisor reports no fault counts (``getrusage``
    reads 0) but does report resident memory.  The count is the
    process's: another thread's allocations and frees in the span count
    too."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1])
    except OSError:
        return None


def snapshot(start_ns: int, end_ns: int) -> Tuple[List[Record], bool]:
    """The process ring's records that meet [start_ns, end_ns], and whether
    any record that met it was dropped."""
    return RING.snapshot(start_ns, end_ns)
