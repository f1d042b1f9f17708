"""A run's result line and exits: the keys the contract names, the
numbers compared at the end of standard error, no result without the
cards, and none with JAX or the JAX package loaded."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from portbench import harness

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def run_small(root, trace, **kw):
    return harness.run_cell(harness.Registry(root), "small", 2**31 + 21, 1.0, trace,
                            time.perf_counter(), device="cpu", check_chip=False, **kw)


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_result_line_keys(bench_copy, trace):
    line, tail = run_small(bench_copy, trace)
    keys = list(line)
    assert keys[: len(REQUIRED)] == REQUIRED
    # beyond the contract's keys: the set-up's parts, the calls' shortest,
    # median and longest seconds, the median and the slow calls, the sweep
    # kernel's launches per call, the window's collections, the card's power
    # limit, the reference's seconds, the traced run's breakdown, and the
    # numbers compared, last
    assert set(keys) - set(REQUIRED) == ({"breakdown"} if trace else set()) | {
        "setup_parts", "call_s", "median_call", "slow_calls", "k2_launches", "gc", "power_limit",
        "reference_s", "checks"}
    # [index, seconds] and, in the window, the call's CPU s, GC s and switches
    assert len(line["median_call"]) == (2 if trace else 5)
    assert set(line["setup_parts"]) == {"interpreter", "torch", "cards", "library", "objects",
                                          "warmup"}
    assert keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU there is no device trace, so no per-layer metric reads
        assert line["metrics"] == {}
    else:
        # and no card's peak memory
        assert set(line["metrics"]) == {"search_comps_per_s", "setup_s"}
    for name, check in line["checks"].items():
        assert f"check {name} {check['value']} limit {check['limit']}" in tail[-len(line["checks"]):]
    assert line["correct"] is True


def test_no_result_without_a_card():
    """On a host without the cell's cards: exit 2, no line on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "search_8m",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout == ""
    assert "needs 1 CUDA device" in r.stderr


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone: no program, so
    no result, whatever the host holds."""
    (tmp_path / "portbench").mkdir()
    subprocess.run(["cp", "-r", str(ROOT / "portbench"), str(tmp_path)], check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(tmp_path)], check=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "search_8m",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_stop_the_run(bench_copy, monkeypatch):
    """A module named jax, or one of the JAX package, loaded by the end of
    the window: no result (top-level names compared whole)."""
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    monkeypatch.setitem(sys.modules, "vid_dup_finder_lib_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vid_dup_finder_lib_tpu.search", object())
    assert harness.forbidden_modules() == ["vid_dup_finder_lib_tpu.search"]
    with pytest.raises(harness.ForbiddenModules):
        run_small(bench_copy, False)


def test_result_is_one_json_line():
    line = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {}}
    assert "\n" not in json.dumps(line)
