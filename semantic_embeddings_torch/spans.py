"""The port's span recorder: named intervals of a train step's host work on
the profiler's clock, and the step's device time split by phase.

Spans are recorded only while a ``torch.profiler`` session records, as the
profiler's own flag (``torch.autograd.profiler._is_profiler_enabled``, set
by its start and cleared by its stop) says: ``fit --profile_dir``'s window
and the benchmark's traced steps.  Outside one, :func:`span` reads that
flag and the recorder's (which ends a session that has stopped recording)
and returns a shared null context: no allocation, no CUDA event and no
profiler range.

A span records its name, its parent (the innermost span open when it
opened), the step it belongs to (the train state's step counter, given to
the step's spans and inherited by the spans inside them) and its start and
end in epoch nanoseconds, the clock of the profiler's events
(``kineto_results.trace_start_ns()`` is on it): ``time.perf_counter_ns()``
plus an offset taken when the session's first span opens.  Each span is
also a profiler range (``record_function``), so it shows in the profiler's
Chrome trace.

The spans ``step`` and ``step.backward`` mark a step's phase boundaries as
they open and close: step start, backward start, update start (the
backward's end: the exchange, the clip and the update follow) and step
end.  On a CUDA device a mark is a timing ``torch.cuda.Event`` from a pool,
recorded on the current stream and read only when the session is collected
(:func:`last_session`), never inside a step; while the stream is being
captured into a CUDA graph no event is recorded.  Elsewhere the marks are
the host's times.

``setup.first_step`` is recorded always, once for the first call of each
train step function (:func:`first_step`): the lazy op registration,
cuDNN's first calls and the kernels' load or build fall in it.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

#: the spans whose opening and closing mark a step's phase boundaries
BOUNDARIES = ("step", "step.backward")
#: a step's phases between its four marks; ``gap`` is a step's end to the
#: next step's start
PHASES = ("forward", "backward", "update", "gap")

_OFF = contextlib.nullcontext()


class Span:
    """One recorded span: ``name``, ``parent`` (a :class:`Span` or None),
    ``step`` (or None), ``start_ns`` and ``end_ns`` (epoch ns, the
    profiler's clock; ``end_ns`` None while it is open).  Used as a context
    manager, it records itself into the recording session."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns", "_device", "_range")

    def __init__(self, name, parent=None, step=None, device=None):
        self.name, self.parent, self.step, self._device = name, parent, step, device
        self.start_ns = self.end_ns = self._range = None

    def __enter__(self):
        self.start_ns = _RECORDER.now()
        _RECORDER.stack.append(self)
        self._range = record_function(self.name)
        self._range.__enter__()
        if self.name in BOUNDARIES:
            _RECORDER.mark(self, 0)
        return self

    def __exit__(self, *exc):
        if self.name in BOUNDARIES:
            _RECORDER.mark(self, 1)
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = _RECORDER.now()
        stack = _RECORDER.stack
        if stack and stack[-1] is self:
            stack.pop()
        return False


class Session:
    """The spans of one profiler session, in the order they opened, and
    once it ended the phase times of its whole steps: ``phases[p]`` lists
    the milliseconds of phase ``p`` (:data:`PHASES`) a step, ``gap`` one a
    pair of consecutive steps; ``clock`` is ``'cuda'`` where CUDA events
    timed them, else ``'host'``."""

    def __init__(self):
        self.spans = []
        self.marks = []  # (step, boundary 0-3, host ns, event or None)
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.recording = True
        self.phases = None
        self.clock = None

    @property
    def steps(self):
        """The step ids of the session's ``step`` spans, in order."""
        return [s.step for s in self.spans if s.name == "step"]

    def collect(self):
        """Reads the marks (waiting for the last event) into ``phases``."""
        cuda = any(event is not None for *_, event in self.marks)
        by_step = {}
        for step, boundary, host_ns, event in self.marks:
            if event is not None or not cuda:
                by_step.setdefault(step, [None] * 4)[boundary] = event if cuda else host_ns
        whole = {s: m for s, m in by_step.items() if None not in m}
        self.clock = "cuda" if cuda else "host"
        self.phases = {p: [] for p in PHASES}
        if not whole:
            return
        if cuda:
            last = max(whole)
            whole[last][3].synchronize()
            first = whole[min(whole)][0]
            times = {s: [first.elapsed_time(e) for e in m] for s, m in whole.items()}
        else:
            times = {s: [t / 1e6 for t in m] for s, m in whole.items()}
        for step in sorted(times):
            start, backward, update, end = times[step]
            self.phases["forward"].append(backward - start)
            self.phases["backward"].append(update - backward)
            self.phases["update"].append(end - update)
            if step + 1 in times:
                self.phases["gap"].append(times[step + 1][0] - end)


class _Recorder:
    """The process's recorder: the recording (or last) session, the spans
    open in it, the pool of timing events and the set-up spans."""

    def __init__(self):
        self.session = None
        self.recording = False
        self.stack = []
        self.pool = []
        self.used = 0
        self.setup = []

    def now(self):
        return time.perf_counter_ns() + self.session.offset_ns

    def open(self, name, step, device):
        if not self.recording:
            self.session, self.recording, self.stack, self.used = Session(), True, [], 0
        parent = self.stack[-1] if self.stack else None
        if parent is not None:
            step = parent.step if step is None else step
            device = parent._device if device is None else device
        span = Span(name, parent, step, device)
        self.session.spans.append(span)
        return span

    def end(self):
        self.recording = self.session.recording = False
        self.stack = []

    def mark(self, span, edge):
        if span.step is None:
            return
        boundary = 3 * edge if span.name == "step" else 1 + edge
        event, device = None, span._device
        if device is not None and device.type == "cuda" and \
                not torch.cuda.is_current_stream_capturing():
            if self.used == len(self.pool):
                self.pool.append(torch.cuda.Event(enable_timing=True))
            event = self.pool[self.used]
            self.used += 1
            event.record(torch.cuda.current_stream(device))
        self.session.marks.append((span.step, boundary, self.now(), event))


_RECORDER = _Recorder()


def span(name, step=None, device=None):
    """A span named ``name`` while a profiler session records, else a shared
    null context.  ``step`` defaults to the enclosing span's, ``device``
    (where the phase marks of :data:`BOUNDARIES` are timed) too."""
    if not _profiler._is_profiler_enabled:
        if _RECORDER.recording:
            _RECORDER.end()
        return _OFF
    return _RECORDER.open(name, step, device)


def first_step(fn):
    """``fn``, a train step, with its first call recorded as the set-up span
    ``setup.first_step`` (host clock, recorded outside sessions too)."""
    called = False

    @functools.wraps(fn)
    def step(*args, **kwargs):
        nonlocal called
        if called:
            return fn(*args, **kwargs)
        called = True
        offset = time.time_ns() - time.perf_counter_ns()
        record = Span("setup.first_step")
        record.start_ns = time.perf_counter_ns() + offset
        with record_function(record.name) if _profiler._is_profiler_enabled else _OFF:
            out = fn(*args, **kwargs)
        record.end_ns = time.perf_counter_ns() + offset
        _RECORDER.setup.append(record)
        return out

    return step


def last_session():
    """The session recording, or else the last one with its phase times
    (read here, once); None before the process's first."""
    session = _RECORDER.session
    if session is None:
        return None
    if _RECORDER.recording and not _profiler._is_profiler_enabled:
        _RECORDER.end()
    if not session.recording and session.phases is None:
        session.collect()
    return session


def setup_spans():
    """The process's set-up spans so far, in order."""
    return list(_RECORDER.setup)
