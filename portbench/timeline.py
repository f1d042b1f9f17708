"""What a traced run reads: the card's timeline from ``torch.profiler``,
and what the host was doing while the card sat idle.

During the traced calls a thread samples the calling thread's stack every
``SAMPLE_S`` seconds, and a ``gc`` callback records each collection.  The
profiler's device events (kernels, copies, sets) give each card's busy
intervals; the calls' ``record_function`` markers tie the profiler's clock
to the host's.  Each idle stretch of a card is charged to the host frame
sampled over it (the innermost frame in the program's package, else in the
harness) or to the collection running then.
"""

from __future__ import annotations

import gc
import re
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

SAMPLE_S = 0.001
MARKER = "portbench.call"
PROGRAM_PACKAGE = "vid_dup_finder_lib_tpu_torch"
_COPY = ("Memcpy", "Memset")
# the profiler's device activities that occupy a card (not its annotations
# of host ranges, nor synchronisations)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# kernels of PyTorch itself: its native ops and the CUB library it ships
_TORCH_OWN = ("at::", "at_cuda_detail", "cub::", "c10::")


def is_device_work(event) -> bool:
    """A kernel, copy or set on a card: not the card's copy of a host
    range's annotation (our markers), nor, where the profiler names the
    kind of an event, anything else it records there."""
    if event.device_type().name != "CUDA" or event.name() == MARKER:
        return False
    kind = getattr(event, "activity_type", None)
    return kind is None or kind() in DEVICE_WORK


def is_copy(name: str) -> bool:
    return name.startswith(_COPY)


def is_program_kernel(name: str) -> bool:
    """A kernel of the program: neither a copy nor PyTorch's own."""
    return not is_copy(name) and not any(t in name for t in _TORCH_OWN)


def clean_name(name: str, limit: int = 64) -> str:
    return re.sub(r"[^A-Za-z0-9_.:/-]+", "_", name)[:limit]


def union_length(intervals: np.ndarray) -> float:
    """Total length covered by ``[start, end)`` rows, overlaps once."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = np.maximum(iv[:, 0], np.concatenate([[iv[0, 0]], ends[:-1]]))
    return float(np.maximum(ends - starts, 0).sum())


def idle_intervals(busy: np.ndarray, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi)`` that no busy interval covers."""
    out, t = [], lo
    for s, e in sorted(busy.tolist()):
        if e <= t:
            continue
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class HostSampler:
    """Samples one thread's stack, and records GC collections, in
    ``time.perf_counter_ns`` time, between ``start`` and ``stop``."""

    def __init__(self, thread_id: int | None = None):
        self.thread_id = thread_id or threading.get_ident()
        self.samples: list[tuple[int, str]] = []
        self.gc_spans: list[tuple[int, int, str]] = []
        self._gc_start: int | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _on_gc(self, phase: str, info: dict) -> None:
        now = time.perf_counter_ns()
        if phase == "start":
            self._gc_start = now
        elif self._gc_start is not None:
            self.gc_spans.append((self._gc_start, now, f"gc:generation_{info.get('generation')}"))
            self._gc_start = None

    def _label(self) -> str:
        frame = sys._current_frames().get(self.thread_id)
        fallback = None
        while frame is not None:
            path = frame.f_code.co_filename.replace("\\", "/")
            if f"/{PROGRAM_PACKAGE}/" in path:
                rel = path.split(f"/{PROGRAM_PACKAGE}/", 1)[1]
                return f"{rel}:{frame.f_code.co_qualname}"
            if fallback is None and "/portbench/" in path:
                fallback = f"portbench/{path.split('/portbench/', 1)[1]}:{frame.f_code.co_qualname}"
            frame = frame.f_back
        return fallback or "other"

    def _loop(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            self.samples.append((time.perf_counter_ns(), self._label()))

    def start(self) -> None:
        gc.callbacks.append(self._on_gc)
        self._thread = threading.Thread(target=self._loop, name="portbench-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)


@dataclass
class TraceReading:
    """One traced window of ``calls`` whole calls, seconds throughout."""

    calls: int
    window_s: float
    devices: list[int]
    busy_s: dict[int, float]  # kernels, copies and sets, overlaps once
    program_kernel_s: dict[int, float]  # kernels that are not PyTorch's own
    device_ops: list[tuple[str, float]] = field(default_factory=list)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)

    def idle_s(self, dev: int) -> float:
        return max(self.window_s - self.busy_s.get(dev, 0.0), 0.0)


def read_profile(prof, call_ns: list[tuple[int, int]], sampler: HostSampler,
                 devices: list[int]) -> TraceReading:
    """Reduce a profile of ``len(call_ns)`` calls, each ``(start, end)`` in
    ``perf_counter_ns``, to a :class:`TraceReading` over ``devices``."""
    events = prof.profiler.kineto_results.events()
    marks = sorted(e.start_ns() for e in events
                   if e.name() == MARKER and e.device_type().name == "CPU")
    if len(marks) != len(call_ns):
        raise RuntimeError(f"the trace holds {len(marks)} call markers for {len(call_ns)} calls")
    # both clocks as nanoseconds from their first marker, in float64 (the
    # profiler's raw ones are ~1e18, past float64's integer range), and
    # the profiler's time minus the host's, from the markers
    base, h0 = marks[0], call_ns[0][0]
    offset = float(np.median([(m - base) - (s - h0) for m, (s, _) in zip(marks, call_ns)]))
    lo, hi = offset, call_ns[-1][1] - h0 + offset
    spans: dict[int, list[tuple[float, float]]] = defaultdict(list)
    program_s: dict[int, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        if not is_device_work(e) or e.device_index() not in devices:
            continue
        s, d = e.start_ns() - base, e.duration_ns()
        s0, e0 = max(s, lo), min(s + d, hi)
        if e0 <= s0:
            continue
        name, dev, sec = e.name(), e.device_index(), (e0 - s0) / 1e9
        spans[dev].append((s0, e0))
        by_name[clean_name(name)] += sec
        if is_program_kernel(name):
            program_s[dev] += sec
    busy = {d: union_length(np.array(spans[d], float).reshape(-1, 2)) / 1e9 for d in devices}
    return TraceReading(
        calls=len(call_ns),
        window_s=(hi - lo) / 1e9,
        devices=list(devices),
        busy_s=busy,
        program_kernel_s={d: program_s[d] for d in devices},
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=_idle_by_host(spans, devices, lo, hi, h0 - offset, sampler)[:10],
    )


def _idle_by_host(spans, devices, lo, hi, host_base, sampler: HostSampler) -> list[tuple[str, float]]:
    """Each card's idle seconds by what the host was doing, averaged over
    the cards, largest first.  Times are the profiler's (``perf_counter_ns``
    minus ``host_base``): the window is cut at the samples, and each slice
    is charged to the sample at its start, less what collections cover."""
    if not sampler.samples:
        return []
    t = np.array([s for s, _ in sampler.samples], float) - host_base
    gcs = [(g0 - host_base, g1 - host_base, g) for g0, g1, g in sampler.gc_spans]
    edges = np.concatenate([[lo], t[(t > lo) & (t < hi)], [hi]])
    at = np.clip(np.searchsorted(t, edges[:-1], side="right") - 1, 0, None)
    labels = [sampler.samples[k][1] for k in at]
    out: dict[str, float] = defaultdict(float)
    for dev in devices:
        busy = np.array(spans[dev], float).reshape(-1, 2)
        for s, e in idle_intervals(busy, lo, hi):
            m0 = int(np.searchsorted(edges, s, side="right")) - 1
            m1 = int(np.searchsorted(edges, e, side="left"))
            for m in range(max(m0, 0), m1):
                a, b = max(s, edges[m]), min(e, edges[m + 1])
                if b <= a:
                    continue
                rest = b - a
                for g0, g1, g in gcs:
                    part = min(b, g1) - max(a, g0)
                    if part > 0:
                        out[g] += part / 1e9 / len(devices)
                        rest -= part
                out[labels[m]] += max(rest, 0.0) / 1e9 / len(devices)
    return sorted(out.items(), key=lambda kv: -kv[1])
