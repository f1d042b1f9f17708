"""Shared fixtures of the benchmark's own tests: the repository root on
``sys.path``, and a copy of the benchmark with a small cell added as files
alone (a configuration, a cell file and their entries in
``BENCHMARK.json``), which the CPU tests run."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_HASHES = 20000


def add_small_cell(root: Path, name: str = "small", hashes: int = SMALL_HASHES,
                   chips: int = 1) -> None:
    """Add cell ``name`` on a ``hashes``-row library to the benchmark
    copied at ``root``, by new files and new entries only, reporting the
    metrics that ``search_8m`` reports."""
    cfg = json.loads((root / "portbench/configs/library_8m.json").read_text())
    cfg.update(name=f"library_{name}", hashes=hashes)
    (root / f"portbench/configs/library_{name}.json").write_text(json.dumps(cfg))
    cell = {"name": name, "config": f"library_{name}", "traffic": "self_search",
            "chips": chips, "why": "a small library for the CPU tests"}
    (root / f"portbench/workloads/{name}.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": f"library_{name}", "source": "test",
                             "file": f"portbench/configs/library_{name}.json",
                             "reduced": ["hashes"], "why": "test"})
    bench["workloads"].append(cell)
    # it reports what the one-card cell reports
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "search_8m" in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    """The benchmark's files (``BENCHMARK.json`` and ``portbench/``)
    copied to a fresh root, with the cell ``small`` added."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_small_cell(tmp_path)
    return tmp_path
