"""The program's own spans in a traced run, for the per-layer metrics
that read them (``metrics/search_*_ms.py``, ``metrics/sweep_*_ms.py``).

While a ``torch.profiler`` records, the program records a span around
each step of a search (``vid_dup_finder_lib_tpu_torch.utils.timers``):
the public call's root ``search``, its steps ``search.build``,
``search.bounds``, ``search.sweep``, ``search.csr``, ``search.replay`` and
``search.groups``, and inside the sweep the host's waits on the card,
``sweep.wait``.  Each has ``name``, ``id``, ``parent``, ``root``,
``start_ns`` / ``end_ns`` (``time.perf_counter_ns``, the clock of
``Run.calls``) and ``gc_ns``.  A program without that recorder (an older
checkout) reads None.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

ROOT = "search"
WAIT = "sweep.wait"
SWEEP = "search.sweep"


def program_spans():
    """The spans the program recorded, or None where it records none."""
    try:
        from vid_dup_finder_lib_tpu_torch.utils import timers
    except ImportError:
        return None
    read = getattr(timers, "spans", None)
    return None if read is None else read()


def per_search(run, value, spans=None) -> float | None:
    """The mean over the traced ``search`` roots that start inside one of
    ``run.calls`` of ``value(root, descendants)`` in ms (``value`` gives
    nanoseconds), or None in an untraced run, a run without a card, or
    where no such root was recorded."""
    if run.trace is None or not run.devices:
        return None
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    calls = [(round(a * 1e9), round(b * 1e9)) for a, b in run.calls]
    roots = [s for s in spans if s.name == ROOT and s.parent is None
             and any(a <= s.start_ns <= b for a, b in calls)]
    if not roots:
        return None
    under = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            under[s.root].append(s)
    return float(np.mean([value(r, under[r.id]) for r in roots])) / 1e6


def duration(s) -> int:
    return s.end_ns - s.start_ns


def named(spans, *names) -> int:
    """The summed durations of ``spans`` named one of ``names``."""
    return sum(duration(s) for s in spans if s.name in names)


def covered(spans, lo: int, hi: int) -> int:
    """How much of ``[lo, hi)`` the spans cover, overlaps once."""
    iv = sorted((max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans)
    total, end = 0, lo
    for a, b in iv:
        a = max(a, end)
        if b > a:
            total += b - a
            end = b
    return total


def self_ns(root, descendants) -> int:
    """The root's duration less what its direct children cover."""
    kids = [s for s in descendants if s.parent == root.id]
    return duration(root) - covered(kids, root.start_ns, root.end_ns)


def waits_ns(descendants) -> int:
    """The time the host waited on the card inside the search's sweeps:
    the ``sweep.wait`` spans, overlaps once."""
    waits = [s for s in descendants if s.name == WAIT]
    return sum(covered(waits, s.start_ns, s.end_ns) for s in descendants if s.name == SWEEP)


def sweep_host_ns(descendants) -> int:
    """The sweeps' time less their waits on the card."""
    return named(descendants, SWEEP) - waits_ns(descendants)
