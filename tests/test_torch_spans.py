"""The port's spans and counters (``utils/timers.py``): nothing recorded,
no clock read and no ``record_function`` opened while no profiler
records; under a CPU ``torch.profiler`` the ``search`` tree of one public
search, the ``refs`` tree of a batched references search, one
``ring.job`` per (shard, step) from the cards' threads with the ring's
``LAST_RING_PHASES`` read from the same clock, ``phase_timer``'s
``cli.*`` spans, and the ``VDF_TORCH_TRACE_DIR`` exporter."""

import gc
import json
import os
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.fixtures import make_fixture_videos
from vid_dup_finder_lib_tpu_torch import VideoHash, search, search_with_references
from vid_dup_finder_lib_tpu_torch.app.app_fns import run_app
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops.hamming import banded_adjacency_host
from vid_dup_finder_lib_tpu_torch.parallel import mesh as port_mesh
from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh
from vid_dup_finder_lib_tpu_torch.utils import timers

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
TOL = 0.35
SEARCH_CHILDREN = ["search.build", "search.bounds", "search.sweep", "search.csr",
                   "search.replay", "search.groups"]
REFS_CHILDREN = ["refs.build", "refs.windows", "refs.matrix", "refs.sweep", "refs.results",
                 "refs.groups"]


def planted(n: int, seed: int, span_s: int = 4000) -> tuple[list, np.ndarray, np.ndarray]:
    """``n`` random 1000-bit hashes with durations in ``[100, 100 +
    span_s)``, a fifth of them near copies (24 bits flipped) of their
    duration neighbour: the batch, its packed rows and its durations."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durs = np.sort(rng.integers(100, 100 + span_s, n))
    for i in range(1, n, 5):
        packed[i] = packed[i - 1]
        packed[i, :3] ^= np.uint32(0xFF)  # 24 bits
        durs[i] = durs[i - 1]
    batch = VideoHash.many_from_packed_u32(packed, [f"/v/{k:05d}.mp4" for k in range(n)], durs)
    return batch, packed, durs


def recorded(fn):
    """``fn()`` under a CPU profiler: its result, the spans recorded and
    the profile's host event names."""
    timers.drain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    return out, timers.drain(), names


def one_root(spans, name):
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == [name]
    root = roots[0]
    assert all(s.root == root.id for s in spans)
    assert all(s.start_ns <= s.end_ns and s.gc_ns >= 0 for s in spans)
    return root


def children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_off_records_nothing_reads_no_clock_and_opens_no_range(monkeypatch):
    batch, _, _ = planted(600, 1)
    reads = []
    clock = types.SimpleNamespace(perf_counter_ns=lambda: reads.append(1) or 0,
                                  time_ns=lambda: reads.append(1) or 0)
    monkeypatch.setattr(timers, "time", clock)

    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} opened while no profiler records")

    monkeypatch.setattr(timers, "_host_range", no_range)
    timers.drain()
    assert not timers.recording()
    groups = search(batch, TOL, backend="device", device="cpu")
    assert groups and timers.spans() == [] and reads == []
    # the shared no-op context: no object made, and the calls allocate no
    # more than a ``with`` on one shared object does
    assert timers.span("a") is timers.span("b", rows=1) and timers.current() is None
    names = ["search.sweep"] * 10000

    def with_span():
        for name in names:
            with timers.span(name):
                timers.count(pairs=1)

    def with_shared():
        for _ in names:
            with timers._NO_SPAN:
                pass

    assert peak_bytes(with_span) <= peak_bytes(with_shared)
    assert reads == [] and timers.spans() == []


def peak_bytes(fn) -> int:
    """The most memory ``fn`` holds at once beyond what it began with, by
    ``tracemalloc``, after one call to warm it."""
    fn()
    gc.collect()
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        fn()
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


@pytest.mark.parametrize("budget", [None, 6])
def test_search_records_its_tree_under_a_profiler(monkeypatch, budget):
    """The ``search`` tree of §2 on the plain kernels: one root, its six
    steps, under ``search.sweep`` the state, each slab with its waits,
    and the fetch; the counts match the result."""
    if budget is not None:
        monkeypatch.setattr(hc, "COUNTS_BUDGET", budget)
    n = 1500
    batch, packed, durs = planted(n, 2)
    groups, spans, names = recorded(lambda: search(batch, TOL, backend="device", device="cpu"))
    root = one_root(spans, "search")
    assert root.counts == {"rows": n, "groups": len(groups)} and groups
    top = children(spans, root)
    assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == SEARCH_CHILDREN
    sweep = next(s for s in top if s.name == "search.sweep")
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), side="right")
    pairs = banded_adjacency_host(packed, bounds, 350)
    assert sweep.counts == {"path": "device", "pairs": len(pairs[0])}
    under = children(spans, sweep)
    state = [s for s in under if s.name == "sweep.state"]
    slabs = [s for s in under if s.name == "sweep.slab"]
    fetch = [s for s in under if s.name == "sweep.wait"]
    assert len(state) + len(slabs) + len(fetch) == len(under)
    n_pad, tiles = -(-n // 128) * 128, -(-n // 128)
    assert [s.counts for s in state] == [{"h2d_bytes": n * 128 + 4 * (n_pad + 2 * tiles)}]
    cut = hc.count_slabs(types.SimpleNamespace(n_ct=hc.launch_metadata(n, np.minimum(bounds, n),
                                                                       tiles)[1]))
    assert len(slabs) == len(cut) > (budget is not None)
    assert sum(s.counts["row_tiles"] for s in slabs) == tiles
    assert all(s.counts["hit_tiles"] > 0 for s in slabs)
    assert [s.counts for s in fetch] == [{"what": "fetch"}]
    for slab in slabs:
        waits = [s.counts["what"] for s in children(spans, slab)]
        assert waits[0] == "hits" and set(waits[1:]) == {"decode"}
    assert {s.name for s in spans} <= names  # every span is a range of the profile
    assert timers.spans() == []  # drained


def test_refs_search_records_its_tree(monkeypatch):
    monkeypatch.setenv("VDF_REFS_NATIVE", "0")
    batch, packed, durs = planted(1200, 3)
    refs = VideoHash.many_from_packed_u32(packed[::10], [f"/r/{k}.mp4" for k in range(120)],
                                          durs[::10])
    assert len(refs) >= 64
    groups, spans, names = recorded(
        lambda: search_with_references(refs, batch, TOL, device="cpu"))
    root = one_root(spans, "refs")
    assert groups
    top = children(spans, root)
    assert [s.name for s in sorted(top, key=lambda s: s.start_ns)] == REFS_CHILDREN
    sweep = next(s for s in top if s.name == "refs.sweep")
    assert {s.name for s in children(spans, sweep)} == {"sweep.state", "sweep.slab", "sweep.wait"}
    assert {s.name for s in spans} <= names


def test_ring_jobs_on_two_threads_share_the_clock_of_its_phases(monkeypatch):
    """Two CPU "cards": each (shard, step) is one ``ring.job`` on its
    device's thread, under the search's ``search.sweep`` span, and
    ``LAST_RING_PHASES["shard_s"]`` holds those spans' durations."""
    mesh = Mesh([torch.device("cpu"), torch.device("cpu", 0)])
    monkeypatch.setattr(port_mesh, "make_mesh", lambda *a, **k: mesh)
    batch, packed, durs = planted(3000, 4, span_s=600)
    ring_cuda.LAST_RING_PHASES = {}
    groups, spans, _ = recorded(lambda: search(batch, TOL, backend="ring", device="cpu"))
    plain = search(batch, TOL, backend="device", device="cpu")
    assert [list(g.contained_paths()) for g in groups] == [list(g.contained_paths()) for g in plain]
    root = one_root(spans, "search")
    sweep = next(s for s in children(spans, root) if s.name == "search.sweep")
    assert sweep.counts["path"] == "ring"
    ring = children(spans, sweep)
    assert [s.name for s in ring if s.name != "ring.job"] == ["ring.plan", "ring.rotate",
                                                               "ring.merge"]
    jobs = [s for s in ring if s.name == "ring.job"]
    ph = ring_cuda.LAST_RING_PHASES
    assert len(jobs) == sum(len(t) for t in ph["shard_s"]) and ph["steps"] == 2
    assert {s.thread for s in jobs} - {root.thread}  # a job ran on another thread
    for job in jobs:
        d, s = job.counts["shard"], job.counts["step"]
        assert ph["shard_s"][d][s] == (job.end_ns - job.start_ns) / 1e9
        assert {c.name for c in children(spans, job)} >= {"sweep.state", "sweep.slab"}
        assert all(c.thread == job.thread for c in children(spans, job))
    assert sum(j.counts["pairs"] for j in jobs) == sweep.counts["pairs"]
    plan, rotate, merge = (next(s for s in ring if s.name == k)
                           for k in ("ring.plan", "ring.rotate", "ring.merge"))
    assert ph["setup"] == plan.seconds and ph["decode"] == merge.seconds
    assert ph["sweep"] == (merge.start_ns - rotate.end_ns) / 1e9


@pytest.mark.parametrize("traced", [False, True])
def test_phase_timer_prints_and_records(monkeypatch, capsys, traced):
    monkeypatch.setenv("VDF_PRINT_TIMINGS", "1")

    def phase():
        with timers.phase_timer("unit_phase"):
            pass

    if traced:
        _, spans, names = recorded(phase)
        assert [s.name for s in spans] == ["cli.unit_phase"] and "cli.unit_phase" in names
    else:
        timers.drain()
        phase()
        assert timers.spans() == []
    name, _, seconds = capsys.readouterr().out.strip().partition(" time: ")
    assert name == "unit_phase" and float(seconds) >= 0
    monkeypatch.setenv("VDF_PRINT_TIMINGS", "0")
    phase()
    assert capsys.readouterr().out == ""


def _read_export(out):
    """The trace's ranges, name to category, and the spans' lines."""
    trace = json.loads((out / "trace.json").read_text())
    ranges = {e["name"]: e.get("cat") for e in trace["traceEvents"] if e.get("ph") == "X"}
    lines = (out / "spans.jsonl").read_text().splitlines()
    clock = json.loads(lines[0])
    assert set(clock) == {"perf_counter_ns", "time_ns"}
    spans = [json.loads(x) for x in lines[1:]]
    # host ranges, not user annotations, which the profiler would copy onto
    # the cards' timelines around their kernels
    assert {ranges.get(s["name"]) for s in spans} == {"cpu_op"}
    return ranges, spans


def test_maybe_torch_trace_writes_the_trace_and_the_spans(monkeypatch, tmp_path):
    batch, _, _ = planted(600, 5)
    with timers.maybe_torch_trace():  # unset: nothing
        assert not timers.recording()
    monkeypatch.setenv("VDF_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    with timers.maybe_torch_trace():
        search(batch, TOL, backend="device", device="cpu")
    _, spans = _read_export(tmp_path / "trace")
    assert {s["name"] for s in spans} >= {"search", *SEARCH_CHILDREN}
    assert timers.spans() == []


def test_cli_run_under_the_trace_dir_exports_its_search(monkeypatch, tmp_path):
    make_fixture_videos(DATA_DIR)
    monkeypatch.setenv("VDF_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    args = ["--files", DATA_DIR, "--cache-file", str(tmp_path / "c.json"),
            "--cropdetect", "letterbox", "--output-format", "json"]
    assert run_app(args, device="cpu") in (0, None)
    _, spans = _read_export(tmp_path / "trace")
    names = [s["name"] for s in spans]
    assert "cli.search" in names and "search" in names
    cli = next(s for s in spans if s["name"] == "cli.search")
    assert all(s["root"] == cli["id"] for s in spans)
