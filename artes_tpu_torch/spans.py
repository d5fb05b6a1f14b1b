"""Spans and counters of the host path, on the clock of the device trace.

A span is a named interval of host time. ``span(name, **attrs)`` is a context
manager; a counter is an attribute set on the open span (``s.set(k=v)``).
Each span records its name, its start and end in ns, its own id, its
parent's id and the id of the job it belongs to: every span opened inside
one ``runner.run_wavelength`` call (its :func:`job` span) carries that
call's job id.

Recording is on inside :func:`recording` (operators and tests) and, for a
job, whenever a ``torch.profiler`` session is active at the job's start, so
a traced window records its jobs and nothing before the profiler starts.
Off, :func:`job` costs one check and :func:`span` returns one shared object
that does nothing: no allocation and no clock read.

Spans stay in memory, in the order they were opened, until a caller takes
them (:func:`take`, or the list a :func:`recording` block holds at its end);
there is no exporter. At most :data:`LIMIT` are kept: past that, spans are
dropped and counted (:func:`dropped`), and a reader that finds drops should
report nothing.

The clock is the one the profiler stamps its host and device events with
(``torch.profiler``'s kineto: the wall clock in ns), so a span can be laid
over the device's intervals of a trace. The stamps are ``time.monotonic_ns()``
plus one offset to the wall clock, taken when a recording starts (the first
span of an empty buffer): a step of the system clock during a recording
cannot reorder its spans.

Device values are read late. A span that needs a value of the device (a
kernel's tallies, its CUDA events) registers a read with :func:`later`, and
the reads run when the spans are read (:func:`recorded`, :func:`take`, the
end of a :func:`recording` block): after a traced window, not inside it, so
a recorded job makes no device work, copy or synchronisation of its own.
Single-threaded: the open spans are one stack.
"""

from __future__ import annotations

import itertools
import time

import torch

# the most spans the buffer keeps (a few hundred bytes each, with its
# attributes); a traced 10-s window of 1e5-photon jobs opens about 40,000
LIMIT = 1 << 18

_spans: list = []          # every span kept, in the order they were opened
_stack: list = []          # the open spans, innermost last
_pending: list = []        # reads of device values (later) not yet run
_dropped = 0
_offset = 0                # wall clock minus monotonic clock, ns
_recordings = 0            # recording() blocks open
_in_job = False            # inside a job that records
_ids = itertools.count(1)
_jobs = itertools.count(1)


# True while a ``torch.profiler`` (or autograd profiler) session is active,
# its CUDA-only form included
_profiling = torch._C._autograd._profiler_enabled


def _now() -> int:
    return time.monotonic_ns() + _offset


class Span:
    """A named interval: ``start`` and ``end`` in ns on the trace's clock
    (``end`` None while open), ``id``, ``parent`` (0 at the top), ``job``
    (0 outside a job) and ``attrs``, the counters set on it."""

    __slots__ = ("name", "start", "end", "id", "parent", "job", "attrs")

    def __init__(self, name: str, attrs: dict, job: int = 0):
        self.name, self.attrs, self.job = name, attrs, job
        self.id = next(_ids)
        self.parent, self.start, self.end = 0, None, None

    def __enter__(self):
        global _offset
        if not _spans:
            _offset = time.time_ns() - time.monotonic_ns()
        if _stack:
            self.parent = _stack[-1].id
            self.job = self.job or _stack[-1].job
        _spans.append(self)
        _stack.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        self.end = _now()
        _stack.pop()
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def ns(self) -> int:
        """The span's duration in ns."""
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, job={self.job}, "
                f"ns={None if self.end is None else self.ns}, {self.attrs})")


class _Job(Span):
    """The span of one job: recording stays on until it ends, whatever
    turned it on."""

    __slots__ = ("_was",)

    def __enter__(self):
        global _in_job
        self._was, _in_job = _in_job, True
        return super().__enter__()

    def __exit__(self, *exc):
        global _in_job
        super().__exit__(*exc)
        _in_job = self._was
        return False


class _Off:
    """What :func:`span` and :func:`job` return while recording is off: one
    shared object that records nothing and is false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False


OFF = _Off()


def _room() -> bool:
    global _dropped
    if len(_spans) < LIMIT:
        return True
    _dropped += 1
    return False


def span(name: str, **attrs):
    """A span named ``name`` with counters ``attrs``, opened by ``with``;
    :data:`OFF` while recording is off (or the buffer is full)."""
    if not (_recordings or _in_job) or not _room():
        return OFF
    return Span(name, attrs)


def job(**attrs):
    """The span of one job (``runner.run_wavelength``), with a new job id;
    it records when a :func:`recording` block is open or a profiler session
    is active now (the one check a job makes), else :data:`OFF`."""
    if not (_recordings or _in_job or _profiling()) or not _room():
        return OFF
    return _Job("job", attrs, next(_jobs))


def later(read) -> None:
    """Run ``read()`` when the spans are next read (:func:`recorded`,
    :func:`take`, the end of a :func:`recording` block): a read of device
    values for a span."""
    _pending.append(read)


def _run_late_reads() -> None:
    """Run the reads :func:`later` registered (each waits for the device
    work it reads)."""
    if not _pending:
        return
    reads = _pending[:]
    del _pending[:]
    for read in reads:
        read()


def take() -> list:
    """The spans kept, which leave the buffer; resets :func:`dropped`."""
    global _dropped
    _run_late_reads()
    out = _spans[:]
    del _spans[:]
    _dropped = 0
    return out


def recorded() -> list:
    """The spans kept so far (the buffer itself, not a copy): each reader of
    a traced window reads them without taking them."""
    _run_late_reads()
    return _spans


def dropped() -> int:
    """Spans dropped since the buffer was last emptied, the buffer being
    full: a reader that finds any reports nothing."""
    return _dropped


class recording:
    """Record every span opened inside the block. At its end ``spans`` holds
    them and ``dropped`` the spans the full buffer dropped; the outermost
    block takes its spans out of the buffer. Blocks nest."""

    def __init__(self):
        self.spans: list = []
        self.dropped = 0

    def __enter__(self):
        global _recordings
        self._first = len(_spans)
        _recordings += 1
        return self

    def __exit__(self, *exc):
        global _recordings, _dropped
        _run_late_reads()
        _recordings -= 1
        self.spans = _spans[self._first:]
        self.dropped = _dropped
        if not _recordings and not _in_job:
            del _spans[self._first:]
            if not _spans:
                _dropped = 0
        return False


def children(spans) -> dict:
    """Each span id's child spans, in the order they were opened."""
    out: dict = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def self_ns(s: Span, kids: dict) -> int:
    """A closed span's duration less its children's."""
    return s.ns - sum(c.ns for c in kids.get(s.id, ()) if c.end is not None)


def self_times(spans) -> dict:
    """Each span name's self time in seconds and its count, ``{name:
    (seconds, count)}``, over the closed spans."""
    kids = children(spans)
    out: dict = {}
    for s in spans:
        if s.end is not None:
            secs, count = out.get(s.name, (0.0, 0))
            out[s.name] = (secs + self_ns(s, kids) * 1e-9, count + 1)
    return out


def self_time_line(spans) -> str:
    """One line of each span name's self time and count, longest first."""
    times = sorted(self_times(spans).items(), key=lambda kv: -kv[1][0])
    return "spans (self time, count): " + ", ".join(
        f"{name} {secs:.6f} s x{count}" for name, (secs, count) in times)
