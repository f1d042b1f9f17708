"""The benchmark on the card: the reference there agrees with the CPU's,
the control fails there too, and a small cell runs whole, traced and not.
They skip where there is no card; on one:

    python3 -m pytest -m cuda portbench/tests -q
"""

import time

import pytest
import torch

from conftest import SMALL_HASHES
from portbench import control, harness, library, reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the benchmark measures the card")
    return "cuda:0"


def small_config():
    return dict(harness.Registry().config("library_8m"), hashes=SMALL_HASHES)


def test_reference_on_the_card_equals_the_cpu(card):
    cfg = small_config()
    lib = library.make_library(cfg, 2**31 + 41)
    args = (lib.packed, lib.durations, lib.paths_bytes, cfg["tolerance"])
    assert reference.self_search_groups(*args, device=card) == \
        reference.self_search_groups(*args, device="cpu")


def test_control_on_the_card(card):
    got = control.control_readings(small_config(), 2**31 + 42, card)
    assert got["control_correct"] is False
    assert got["checks"]["groups_differing"]["value"] >= 20


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_small_cell_on_the_card(card, bench_copy, trace):
    line, _ = harness.run_cell(harness.Registry(bench_copy), "small", 2**31 + 43, 2.0, trace,
                               time.perf_counter())
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == torch.cuda.device_count()
    if not trace:
        assert set(line["metrics"]) == {"search_comps_per_s", "peak_device_gib", "setup_s"}
        return
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
    m = line["metrics"]
    assert 0 <= m["device_idle_pct"]["value"] <= 100
    assert 0 < m["sweep_int8_roofline_pct"]["value"] <= 100
    assert m["host_ms_per_search"]["value"] > 0
