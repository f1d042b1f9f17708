"""Spans and counters of the port, phase timing, and the trace exporter
(counterpart of ``vid_dup_finder_lib_tpu/utils/timers.py``).

The recorder is on while a ``torch.profiler`` records (its flag,
``torch.autograd.profiler._is_profiler_enabled``), and so under
:func:`maybe_torch_trace`.  Then each :func:`span` records its name, its
id, its parent's and its root's ids (the spans of one public call share
the root), its thread, its start and end in ``time.perf_counter_ns``, the
GC time that fell inside it (``gc_ns``) and its counts, into a bounded
buffer in memory (:func:`spans`, :func:`drain`), and opens a profiler
range of its name on the host (``_host_range``: ``record_function``'s
function-scope form), so that the profile shows it on the host's timeline
beside the kernels it launched.  Off, ``span(name)`` costs one flag check
and returns a shared context that does nothing: no clock read, no
allocation, no profiler range.  ``span(..., timed=True)`` reads the
clock on and off, for callers that report their own times (the ring's
``LAST_RING_PHASES``, :func:`phase_timer`); it records only while on.

A span opened on another thread than its parent's (the ring's jobs, one
thread per card) names its parent (``parent=``, from :func:`current` on
the calling thread).

Replaces the reference's compile-time ``print_timings`` feature
(``vid_dup_finder_app/Cargo.toml:30``, timing prints across app_fns.rs) with
runtime switches: ``VDF_PRINT_TIMINGS=1`` prints each CLI phase's wall
time; ``VDF_TORCH_TRACE_DIR=/path`` writes a profiler trace of the CLI's
search phase, with the spans in it, and the spans as JSON lines
(:func:`maybe_torch_trace`).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import sys
import threading
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler

# a profiler range of the function scope: a range on the host's timeline,
# which the profiler does not copy onto the cards' timelines as it does a
# ``record_function`` (a user annotation) around kernels
_host_range = torch._C._profiler._RecordFunctionFast

SPAN_BUFFER = 1 << 16  # most spans kept; the oldest go first


class Span:
    """One span: ``name``, ``id``, ``parent`` and ``root`` ids (None and
    the own id for a root), ``thread``, ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``), ``gc_ns`` and ``counts``.  ``id`` is None
    for a timed span opened while the recorder is off."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns", "end_ns",
                 "gc_ns", "counts", "_gc0", "_range")

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("name", "id", "parent", "root", "thread", "start_ns", "end_ns", "gc_ns", "counts")}

    def __enter__(self) -> "Span":
        self.start_ns = time.perf_counter_ns()
        if self.id is not None:
            _RECORDER.opened(self)
            self._range = _host_range(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.id is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.perf_counter_ns()
        if self.id is not None:
            _RECORDER.closed(self)


class _NoSpan:
    """The shared context of a span while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NO_SPAN = _NoSpan()


class _Recorder:
    """The spans recorded so far, each thread's open spans, and the GC
    clock, installed as a ``gc.callbacks`` entry while any span is open."""

    def __init__(self, size: int = SPAN_BUFFER):
        self.done: collections.deque[Span] = collections.deque(maxlen=size)
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()
        self.open = 0
        self.gc_ns = 0  # GC time so far, while installed
        self._gc_start = None
        # (perf_counter_ns, time_ns) when the recorder last turned on: the
        # profiler stamps its events on the second clock
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def stack(self) -> list[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def new(self, name: str, parent: Span | None, counts: dict) -> Span:
        s = Span()
        s.name, s.counts, s.gc_ns, s._range = name, counts, 0, None
        s.id, s.thread = next(self.ids), threading.get_ident()
        if parent is None:
            st = self.stack()
            parent = st[-1] if st else None
        s.parent = None if parent is None else parent.id
        s.root = s.id if parent is None else parent.root
        return s

    def opened(self, s: Span) -> None:
        with self.lock:
            if self.open == 0:
                self.clock = (time.perf_counter_ns(), time.time_ns())
                gc.callbacks.append(self._on_gc)
            self.open += 1
        s._gc0 = self.gc_ns
        self.stack().append(s)

    def closed(self, s: Span) -> None:
        st = self.stack()
        if s in st:
            st.remove(s)
        s.gc_ns = self.gc_ns - s._gc0
        with self.lock:
            self.done.append(s)
            self.open -= 1
            if self.open == 0:
                gc.callbacks.remove(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        now = time.perf_counter_ns()
        if phase == "start":
            self._gc_start = now
        elif self._gc_start is not None:
            self.gc_ns += now - self._gc_start
            self._gc_start = None


_RECORDER = _Recorder()


def recording() -> bool:
    """Whether spans are recorded: while a ``torch.profiler`` records."""
    return _profiler._is_profiler_enabled


def span(name: str, parent: Span | None = None, timed: bool = False, **counts):
    """A context manager around one step: while the recorder is on, a
    recorded :class:`Span` under ``parent`` (default: the calling thread's
    innermost open span) with ``counts``; off, the shared no-op context,
    or with ``timed`` a :class:`Span` that reads the clock alone."""
    if not _profiler._is_profiler_enabled:
        if not timed:
            return _NO_SPAN
        s = Span()
        s.id = None
        return s
    return _RECORDER.new(name, parent, counts)


def current() -> Span | None:
    """The calling thread's innermost open recorded span, the ``parent``
    of a span opened for it on another thread."""
    if not _profiler._is_profiler_enabled:
        return None
    st = _RECORDER.stack()
    return st[-1] if st else None


def count(**kv) -> None:
    """Add ``kv`` to the counts of the calling thread's innermost open
    span: numbers add up, anything else replaces."""
    if not _profiler._is_profiler_enabled:
        return
    st = _RECORDER.stack()
    if not st:
        return
    counts = st[-1].counts
    for k, v in kv.items():
        old = counts.get(k)
        number = isinstance(v, (int, float)) and not isinstance(v, bool)
        counts[k] = old + v if number and isinstance(old, (int, float)) else v


def spans() -> list[Span]:
    """The spans recorded and closed so far (a snapshot, oldest first)."""
    with _RECORDER.lock:
        return list(_RECORDER.done)


def drain() -> list[Span]:
    """The spans recorded and closed so far, which the buffer then forgets."""
    with _RECORDER.lock:
        out = list(_RECORDER.done)
        _RECORDER.done.clear()
    return out


def timings_enabled() -> bool:
    return os.environ.get("VDF_PRINT_TIMINGS", "") not in ("", "0")


@contextlib.contextmanager
def phase_timer(name: str):
    """The CLI phase ``name`` as the span ``cli.<name>``; its wall time
    printed under ``VDF_PRINT_TIMINGS``."""
    s = span(f"cli.{name}", timed=True)
    try:
        with s:
            yield
    finally:
        if timings_enabled():
            print(
                f"{name} time: {s.seconds}",
                file=sys.stdout,
            )


@contextlib.contextmanager
def maybe_torch_trace():
    """Under ``VDF_TORCH_TRACE_DIR``, a ``torch.profiler`` (the CPU, and
    CUDA where there is a card) around the block, then in that directory
    its Chrome trace (``trace.json``, every span a range beside the
    kernels) and ``spans.jsonl``: first the clock pair
    ``{"perf_counter_ns", "time_ns"}``, then one span a line."""
    trace_dir = os.environ.get("VDF_TORCH_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    drain()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    pc, wall = _RECORDER.clock
    with open(out / "spans.jsonl", "w") as f:
        f.write(json.dumps({"perf_counter_ns": pc, "time_ns": wall}) + "\n")
        for s in drain():
            f.write(json.dumps(s.as_dict()) + "\n")
