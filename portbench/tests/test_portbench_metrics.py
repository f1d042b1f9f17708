"""The arithmetic of the metrics: the sweep's roofline, the timeline's
busy and idle time, and each reader on a made-up run."""

import numpy as np
import pytest

from portbench import harness, peaks, timeline
from portbench.timeline import TraceReading


def test_sweep_bound_at_1m():
    # 4.587e10 in-band pairs x 1000 bits x 2 int8 operations at 1,979 TOP/s:
    # chip_smoke's bound_ms of 47.468 counts the 1024 bits of a padded tile
    assert peaks.sweep_bound_s(45_870_000_000, 1000) * 1e3 == pytest.approx(46.36, abs=0.01)
    assert peaks.sweep_bound_s(45_870_000_000, 1024) * 1e3 == pytest.approx(47.47, abs=0.01)


def test_union_and_idle_intervals():
    iv = np.array([[0, 10], [5, 15], [20, 30], [22, 25]], float)
    assert timeline.union_length(iv) == 25
    assert timeline.idle_intervals(iv, 0, 40) == [(15, 20), (30, 40)]
    assert timeline.idle_intervals(iv, -5, 12) == [(-5, 0)]
    assert timeline.union_length(np.zeros((0, 2))) == 0


def test_kernel_classes():
    assert timeline.is_copy("Memcpy HtoD (Pinned -> Device)")
    assert timeline.is_copy("Memset (Device)")
    assert not timeline.is_program_kernel("void at::native::radixSortKVInPlace<2, -1>(...)")
    assert not timeline.is_program_kernel("void at_cuda_detail::cub::DeviceSelectSweepKernel<...>")
    assert timeline.is_program_kernel("(anonymous namespace)::band_counts_kernel<int const>")


def made_up_run(devices=(0,), calls=2):
    reading = TraceReading(
        calls=calls, window_s=2.0, devices=list(devices),
        busy_s={d: 1.0 + 0.2 * d for d in devices},
        program_kernel_s={d: 0.1 for d in devices})
    return harness.Run(cell={}, config={"hash_bits": 1000}, traffic={}, setup_s=5.0,
                       comps_per_call=45_870_000_000, calls=[(0.0, 1.0), (1.0, 2.0)],
                       devices=len(devices), peak_bytes=2**30, trace=reading)


def test_readers_on_a_made_up_trace():
    reg = harness.Registry()
    one, four = made_up_run(), made_up_run(devices=(0, 1, 2, 3))
    assert reg.reader("device_idle_pct")(one) == pytest.approx(50.0)
    assert reg.reader("device_idle_pct")(four) == pytest.approx(100 * (1 - 1.3 / 2))
    assert reg.reader("host_ms_per_search")(one) == pytest.approx(500.0)
    assert reg.reader("host_ms_per_search")(four) == pytest.approx(1000 * (2 - 1.6) / 2)
    # two calls, 0.1 s of the program's kernels on each card in all
    assert reg.reader("sweep_int8_roofline_pct")(one) == pytest.approx(
        100 * peaks.sweep_bound_s(45_870_000_000, 1000) / 0.05)
    # the window's metrics read nothing from a traced run, and the trace's
    # nothing from an untraced one
    assert reg.reader("search_comps_per_s")(one) is None
    plain = made_up_run()
    plain.trace = None
    assert reg.reader("search_comps_per_s")(plain) == pytest.approx(2 * 45_870_000_000 / 2.0)
    assert reg.reader("peak_device_gib")(plain) == 1.0
    assert reg.reader("setup_s")(plain) == 5.0
    for name in ("device_idle_pct", "host_ms_per_search", "sweep_int8_roofline_pct"):
        assert reg.reader(name)(plain) is None


def test_idle_gaps_are_charged_to_host_frames_and_gc():
    sampler = timeline.HostSampler()
    sampler.samples = [(0, "search.py:Search.__init__"), (400, "match_group.py:MatchGroup.new"),
                       (800, "other")]
    sampler.gc_spans = [(850, 900, "gc:generation_0")]
    spans = {0: [(100.0, 300.0), (500.0, 700.0)]}
    got = dict(timeline._idle_by_host(spans, [0], 0.0, 1000.0, 0.0, sampler))
    assert got == pytest.approx({"search.py:Search.__init__": 200e-9,
                                 "match_group.py:MatchGroup.new": 200e-9,
                                 "other": 150e-9, "gc:generation_0": 50e-9})
