"""The seven readers of the program's spans (``portbench/spans.py``): each
value on a made-up span list, the six that partition a search summing to
its root, and None where there is nothing to read; on the program's own
spans of a CPU search, the partition again; and on the card (``cuda``
marker), a traced run of the small cell that reads all seven."""

import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import add_small_cell
from portbench import harness, spans
from portbench.timeline import TraceReading

MS = 1_000_000
READERS = ["search_build_ms", "search_bounds_csr_ms", "search_replay_ms", "search_self_ms",
           "sweep_host_ms", "sweep_wait_ms", "search_gc_ms"]
PARTITION = READERS[:6]  # search_gc_ms overlaps the others


class Made:
    """A made-up span list, built as the program records it."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, t0_ms, t1_ms, parent=None, base=0, gc_ms=0, **counts):
        sid = self.next_id
        self.next_id += 1
        root = sid if parent is None else parent.root
        s = types.SimpleNamespace(name=name, id=sid, parent=None if parent is None else parent.id,
                                  root=root, thread=1, start_ns=base + t0_ms * MS,
                                  end_ns=base + t1_ms * MS, gc_ns=gc_ms * MS, counts=counts)
        self.spans.append(s)
        return s

    def search(self, base, build_ms, parent=None):
        """One search from ``base`` ns, 900 ms plus ``build_ms`` - 100:
        build, bounds 40, sweep 600 (state 20, one slab whose waits are
        400 + 10, a fetch of 40), csr 40, replay 60, groups 30, 30 ms of
        its own, 25 ms of GC."""
        x = build_ms - 100
        root = self.add("search", 0, 900 + x, parent=parent, base=base, gc_ms=25)
        self.add("search.build", 10, 110 + x, root, base)
        self.add("search.bounds", 110 + x, 150 + x, root, base)
        sweep = self.add("search.sweep", 150 + x, 750 + x, root, base, path="device")
        self.add("sweep.state", 150 + x, 170 + x, sweep, base)
        slab = self.add("sweep.slab", 170 + x, 700 + x, sweep, base)
        self.add("sweep.wait", 200 + x, 600 + x, slab, base, what="hits")
        self.add("sweep.wait", 610 + x, 620 + x, slab, base, what="decode")
        self.add("sweep.wait", 700 + x, 740 + x, sweep, base, what="fetch")
        self.add("search.csr", 750 + x, 790 + x, root, base)
        self.add("search.replay", 790 + x, 850 + x, root, base)
        self.add("search.groups", 850 + x, 880 + x, root, base)
        return root


def made_up_run(devices=1, traced=True):
    reading = TraceReading(calls=2, window_s=2.0, devices=list(range(devices)),
                           busy_s={d: 1.0 for d in range(devices)},
                           program_kernel_s={d: 0.5 for d in range(devices)})
    return harness.Run(cell={}, config={"hash_bits": 1000}, traffic={}, setup_s=5.0,
                       comps_per_call=1, calls=[(1.0, 2.0), (2.0, 3.0)], devices=devices,
                       trace=reading if traced else None)


@pytest.fixture
def made(monkeypatch):
    m = Made()
    m.search(10**9 + 1000, 100)
    m.search(2 * 10**9 + 1000, 200)
    m.search(5 * 10**9, 900)  # outside the calls
    cli = m.add("cli.search", 0, 1, base=2 * 10**9)
    m.search(2 * 10**9 + 2000, 900, parent=cli)  # not a root
    monkeypatch.setattr(spans, "program_spans", lambda: m.spans)
    return m


def test_readers_on_a_made_up_span_list(made):
    reg = harness.Registry()
    got = {name: reg.reader(name)(made_up_run()) for name in READERS}
    assert got == pytest.approx({
        "search_build_ms": 150.0, "search_bounds_csr_ms": 80.0, "search_replay_ms": 90.0,
        "search_self_ms": 30.0, "sweep_host_ms": 150.0, "sweep_wait_ms": 450.0,
        "search_gc_ms": 25.0})
    # the six cover each search once: their sum is its mean duration
    assert sum(got[n] for n in PARTITION) == pytest.approx((900 + 1000) / 2)


@pytest.mark.parametrize("case", ["untraced", "no_card", "no_search", "no_recorder"])
def test_readers_read_nothing_where_there_is_nothing(made, monkeypatch, case):
    run = made_up_run(devices=0 if case == "no_card" else 1, traced=case != "untraced")
    if case == "no_search":
        made.spans[:] = [s for s in made.spans if s.name != "search"]
    if case == "no_recorder":  # a program whose timers have no spans()
        monkeypatch.setattr(spans, "program_spans", lambda: None)
    reg = harness.Registry()
    assert {name: reg.reader(name)(run) for name in READERS} == dict.fromkeys(READERS)


def test_the_program_spans_of_a_cpu_search_partition_it():
    """The program's own spans, from a search on the CPU's plain kernels,
    read with a made-up card: the six cover the call."""
    from vid_dup_finder_lib_tpu_torch import VideoHash, search
    from vid_dup_finder_lib_tpu_torch.utils import timers

    rng = np.random.default_rng(3)
    packed = rng.integers(0, 2**32, (2000, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)  # 1000 bits
    packed[1::4] = packed[::4]
    durs = np.arange(2000) // 2 + 100
    batch = VideoHash.many_from_packed_u32(packed, [f"/v/{k}" for k in range(2000)], durs)
    timers.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        a = time.perf_counter_ns()
        search(batch, 0.35, backend="device", device="cpu")
        b = time.perf_counter_ns()
    run = made_up_run()
    run.calls = [(a / 1e9, b / 1e9)]
    reg = harness.Registry()
    got = {name: reg.reader(name)(run) for name in READERS}
    root = next(s for s in timers.drain() if s.name == "search")
    assert sum(got[n] for n in PARTITION) == pytest.approx((root.end_ns - root.start_ns) / MS)
    assert all(v >= 0 for v in got.values())


@pytest.mark.cuda
def test_small_cell_traced_on_the_card_reads_all_seven(bench_copy):
    """A traced run on the card at 200,000 hashes reads all seven, and the
    six cover the calls within 2%: the harness's own work in a call (its
    marker range, the sync; ~0.3 ms) stays under 2% of a search of 15 ms
    and more, not of the 20,000-hash cell's 8 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the spans' metrics read a traced run on the card")
    add_small_cell(bench_copy, "spans_200k", hashes=200_000)
    line, _ = harness.run_cell(harness.Registry(bench_copy), "spans_200k", 2**31 + 47, 2.0, True,
                               time.perf_counter())
    assert line["correct"] is True and line["attempted"] > 1
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READERS) <= set(m) and all(m[n] >= 0 for n in READERS), m
    # the traced calls run back to back: their mean wall time
    call_ms = 1000 * line["device"]["window_s"] / line["attempted"]
    assert sum(m[n] for n in PARTITION) == pytest.approx(call_ms, rel=0.02), (m, call_ms)
