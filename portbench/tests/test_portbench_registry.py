"""The benchmark is found by name: every cell, configuration, mix and
metric of ``BENCHMARK.json`` loads from its own files, the file keeps to
the contract's shape, and a cell added as files alone runs."""

import json
import re
import time

import pytest

from conftest import ROOT
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def reg():
    return harness.Registry()


def test_benchmark_json_shape(reg):
    b = reg.bench
    assert set(b) == TOP_KEYS
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its allowance
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for kind, keys in KEYS.items():
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names)), kind
        for e in b[kind]:
            assert set(e) - {"workloads"} == keys, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e and kind in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)


def test_every_entry_loads_by_name(reg):
    b = reg.bench
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    used_configs = set()
    for w in b["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["why"] == w["why"]
        cfg = reg.config(cell["config"])
        used_configs.add(cell["config"])
        assert cfg["name"] == cell["config"]
        for key in ("hash_bits", "tolerance", "window_factor", "hashes", "assumed", "reduced",
                    "source", "guarantees"):
            assert key in cfg, (cfg["name"], key)
        assert reg.traffic(cell["traffic"])["name"] == cell["traffic"]
        reported = [m["name"] for m in reg.metrics(w["name"], harness.END_TO_END)]
        assert "setup_s" in reported and len(reported) >= 2
        assert reg.metrics(w["name"], harness.PER_LAYER)
    assert used_configs == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert c["reduced"] == reg.config(c["name"])["reduced"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(reg.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert NAME.match(m["moves"])


def test_cell_files_match_benchmark(reg):
    on_disk = {p.stem for p in (ROOT / "portbench/workloads").glob("*.json")}
    assert on_disk == {w["name"] for w in reg.bench["workloads"]}


def test_cell_added_as_files_alone_runs(bench_copy):
    reg = harness.Registry(bench_copy)
    line, tail = harness.run_cell(reg, "small", 2**31 + 11, 1.0, False, time.perf_counter(),
                                  device="cpu", check_chip=False)
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"search_comps_per_s", "setup_s"}
    assert line["metrics"]["search_comps_per_s"]["unit"] == "comps/s"
    assert tail[-3:] == [f"check {k} 0 limit 0" for k in line["checks"]]
    assert json.loads(json.dumps(line)) == line


def test_mix_with_its_own_module_added_as_files_alone(bench_copy):
    """A mix whose calls need code: ``traffic/<mix>.json`` and
    ``traffic/<mix>.py`` (here the public search on the host's native
    sweep), and a cell on it."""
    traffic = bench_copy / "portbench/traffic"
    mix = json.loads((traffic / "self_search.json").read_text())
    mix.update(name="self_search_native", call="search_native")
    (traffic / "self_search_native.json").write_text(json.dumps(mix))
    (traffic / "self_search_native.py").write_text(
        "from portbench.harness import SelfSearch\n\n\n"
        "def make(cfg, mix, lib, device):\n"
        "    drive = SelfSearch(cfg, mix, lib, device)\n"
        "    drive.kwargs['backend'] = 'native'\n"
        "    return drive\n")
    cell = {"name": "small_native", "config": "library_small", "traffic": "self_search_native",
            "chips": 1, "why": "the small library on the native sweep"}
    (bench_copy / "portbench/workloads/small_native.json").write_text(json.dumps(cell))
    bench = json.loads((bench_copy / "BENCHMARK.json").read_text())
    bench["workloads"].append(cell)
    (bench_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = harness.run_cell(harness.Registry(bench_copy), "small_native", 9, 0.5, False,
                               time.perf_counter(), device="cpu", check_chip=False)
    assert line["correct"] is True and line["attempted"] >= 1
