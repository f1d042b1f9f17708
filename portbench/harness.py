"""One run of one cell: make the library from the seed, set the program
up, drive it for a window (or trace a short one), check what it returned
against the plain reference, and print one result line.

Everything a cell needs is found by name (``portbench/README.md``):
``BENCHMARK.json`` at the root of the checkout lists the cells and which
metrics each reports; ``portbench/workloads/<cell>.json``,
``portbench/configs/<config>.json`` and ``portbench/traffic/<mix>.json``
hold their parameters; ``portbench/metrics/<metric>.py`` reads each
metric from the run's record (:class:`Run`).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from . import library as libmod
from .timeline import MARKER, HostSampler, TraceReading, read_profile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "vid_dup_finder_lib_tpu")
END_TO_END, PER_LAYER = "end_to_end", "per_layer"


class Registry:
    """The cells, configurations, mixes and metric readers, by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "portbench"

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.bench[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json has no {kind} entry named {name!r}")

    def cell(self, name: str) -> dict:
        entry = self._entry("workloads", name)
        cell = json.loads((self.dir / "workloads" / f"{name}.json").read_text())
        for key in ("config", "traffic", "chips"):
            if cell[key] != entry[key]:
                raise ValueError(f"cell {name}: {key} is {cell[key]!r} in its file"
                                 f" and {entry[key]!r} in BENCHMARK.json")
        return cell

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The metrics of ``kind`` that ``cell`` reports."""
        return [m for m in self.bench[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return _load(self.dir / "metrics" / f"{metric}.py", f"portbench_metric_{metric}").read


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What one run recorded, for the metric readers (seconds throughout)."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    comps_per_call: int  # comparisons one call makes
    calls: list[tuple[float, float]]  # (start, end) of each call, host clock
    failed: int = 0
    devices: int = 0
    peak_bytes: int = 0
    trace: TraceReading | None = None

    @property
    def window_s(self) -> float:
        return self.calls[-1][1] - self.calls[0][0]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (an entry set to None only blocks an import)."""
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.split(".", 1)[0] in FORBIDDEN)


class SelfSearch:
    """The ``search`` call: the public ``search()`` over the whole library,
    as one ``VideoHash.many_from_packed_u32`` batch built in set-up."""

    def __init__(self, cfg: dict, mix: dict, lib: libmod.Library, device):
        from vid_dup_finder_lib_tpu_torch import VideoHash, search
        from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import band_counts

        self.lib, self.cfg = lib, cfg
        self._k2 = band_counts  # the program's launch counter of its sweep kernel
        self.launches: list[int] = []
        self.batch = VideoHash.many_from_packed_u32(lib.packed, lib.paths(), lib.durations)
        self.kwargs = {"tolerance": cfg["tolerance"], "backend": mix["backend"]}
        if device is not None:
            self.kwargs["device"] = device
        self._search = search
        self.comps = libmod.band_pairs(libmod.self_bounds(lib.durations, cfg["window_factor"]))

    def __call__(self):
        before = self._k2.launches
        out = self._search(self.batch, **self.kwargs)
        self.launches.append(self._k2.launches - before)
        return out

    def expected(self, ref_device) -> list[tuple[str, ...]]:
        from . import reference  # torch: imported once the cards are chosen

        lib, cfg = self.lib, self.cfg
        return reference.self_search_groups(
            lib.packed, lib.durations, lib.paths_bytes, cfg["tolerance"],
            cfg["window_factor"], cfg["hash_bits"], device=ref_device)

    @staticmethod
    def answer(result) -> list[tuple[str, ...]]:
        return [tuple(g.contained_paths()) for g in result]

    def planted(self) -> list[tuple[str, ...]]:
        paths = self.lib.paths_bytes
        return [tuple(p.decode() for p in paths[list(g)].tolist()) for g in self.lib.planted]


def make_driver(reg: Registry, mix_name: str, cfg: dict, mix: dict, lib, device):
    """The mix's own module ``traffic/<mix>.py`` (its ``make``), when there
    is one, else the general driver of the mix's ``call``."""
    path = reg.dir / "traffic" / f"{mix_name}.py"
    if path.exists():
        return _load(path, f"portbench_traffic_{mix_name}").make(cfg, mix, lib, device)
    if mix["call"] != "search":
        raise ValueError(f"mix {mix_name}: call {mix['call']!r} needs traffic/{mix_name}.py")
    return SelfSearch(cfg, mix, lib, device)


def compare(answers: list[list[tuple[str, ...]]], want: list[tuple[str, ...]],
            planted: list[tuple[str, ...]]) -> dict[str, dict]:
    """The numbers that decide ``correct``, each with its limit.

    ``groups_differing``: the most groups by which one call's answer
    differs from the reference's (each group missing or extra counts one;
    the same groups in another order count one).  ``calls_differing``:
    the calls whose answer is not the reference's, group for group and in
    order.  ``planted_groups_missing``: planted groups that the reference
    itself does not find, which guards the reference."""
    want_set = set(want)
    worst = differing = 0
    for got in answers:
        if got == want:
            continue
        differing += 1
        gap = len(set(got) ^ want_set)
        worst = max(worst, gap if gap else 1)
    return {
        "groups_differing": {"value": worst, "limit": 0},
        "calls_differing": {"value": differing, "limit": 0},
        "planted_groups_missing": {"value": len(set(planted) - want_set), "limit": 0},
    }


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().replace("\n", "; ") or None


def _set_environment(chips: int) -> None:
    """Only the cell's cards visible (where the caller has not chosen
    them).  The program keeps its own build caches inside the checkout
    (``build/vdf_torch_kernels``, ``build/vdf_torch_native``)."""
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(str(k) for k in range(chips)))


def run_cell(reg: Registry, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device=None, check_chip: bool = True) -> tuple[dict, list[str]]:
    """One run of cell ``name``: its result line (a dict) and the lines
    that end standard error.  ``device=None`` drives the program on its
    default device, the card; the tests name ``cpu`` and set
    ``check_chip=False``."""
    parts = {"interpreter": time.perf_counter() - t0}
    stamp = time.perf_counter()
    import torch

    parts["torch"] = time.perf_counter() - stamp
    cell = reg.cell(name)
    cfg = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    chips = int(cell["chips"])
    on_card = device is None or torch.device(device).type == "cuda"
    if check_chip and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise ChipMissing(
            f"cell {name} needs {chips} CUDA device(s); torch.cuda.is_available() is"
            f" {torch.cuda.is_available()}, device_count() is"
            f" {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    n_dev = torch.cuda.device_count() if on_card else 0

    def sync():
        for d in range(n_dev):
            torch.cuda.synchronize(d)

    stamp = time.perf_counter()
    for d in range(n_dev):
        torch.empty(0, device=f"cuda:{d}")  # each card's context
    parts["cards"] = time.perf_counter() - stamp
    stamp = time.perf_counter()
    lib = libmod.make_library(cfg, seed)
    parts["library"] = time.perf_counter() - stamp
    stamp = time.perf_counter()
    drive = make_driver(reg, cell["traffic"], cfg, mix, lib, device)
    parts["objects"] = time.perf_counter() - stamp
    parts["warmup"] = []
    for _ in range(int(mix.get("warmup_calls", 1))):
        stamp = time.perf_counter()
        drive()
        sync()
        parts["warmup"].append(time.perf_counter() - stamp)
    setup_s = time.perf_counter() - t0
    for d in range(n_dev):
        torch.cuda.reset_peak_memory_stats(d)

    results, calls = [], []
    reading = None
    collections = GcLog()
    usage = []  # each call's process CPU s, GC s and involuntary switches
    if not trace:
        gc.callbacks.append(collections)
        start = time.perf_counter()
        try:
            while not calls or time.perf_counter() - start < seconds:
                before = _usage(collections)
                a = time.perf_counter()
                results.append(drive())
                calls.append((a, time.perf_counter()))
                usage.append([y - x for x, y in zip(before, _usage(collections))])
            sync()
        finally:
            gc.callbacks.remove(collections)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if n_dev else [])
        limit = min(float(mix.get("trace_seconds", seconds)), seconds)
        sampler = HostSampler()
        call_ns = []
        with profile(activities=acts) as prof:
            sampler.start()
            start = time.perf_counter()
            try:
                while not calls or time.perf_counter() - start < limit:
                    a = time.perf_counter_ns()
                    with record_function(MARKER):
                        results.append(drive())
                        sync()
                    call_ns.append((a, time.perf_counter_ns()))
                    calls.append((a / 1e9, call_ns[-1][1] / 1e9))
            finally:
                sampler.stop()
        reading = read_profile(prof, call_ns, sampler, list(range(n_dev)))
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(n_dev)), default=0)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    run = Run(cell=cell, config=cfg, traffic=mix, setup_s=setup_s,
              comps_per_call=drive.comps, calls=calls, devices=n_dev,
              peak_bytes=int(peak), trace=reading)
    answers = [drive.answer(r) for r in results]
    del results
    if n_dev:
        torch.cuda.empty_cache()
    ref_t = time.perf_counter()
    want = drive.expected("cuda:0" if on_card else "cpu")
    checks = compare(answers, want, drive.planted())
    run.failed = checks["calls_differing"]["value"]
    reference_s = time.perf_counter() - ref_t
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    kind = PER_LAYER if trace else END_TO_END
    metrics = {}
    for m in reg.metrics(name, kind):
        value = reg.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": n_dev,
        "memory_peak_bytes": int(peak),
    }
    if reading is not None:
        dev["busy_s"] = (sum(reading.busy_s.values()) / len(reading.devices)
                         if reading.devices else 0.0)
        dev["window_s"] = reading.window_s
    line = {"correct": correct, "attempted": len(calls), "failed": run.failed,
            "metrics": metrics, "device": dev}
    if reading is not None:
        line["breakdown"] = {"device_ops": [list(x) for x in reading.device_ops],
                             "idle_gaps": [list(x) for x in reading.idle_gaps]}
    line["setup_parts"] = parts
    call_s = [b - a for a, b in calls]
    order = sorted(range(len(call_s)), key=call_s.__getitem__)
    mid = order[len(order) // 2]

    def described(k):
        return [k, call_s[k]] + usage[k] if usage else [k, call_s[k]]

    # the calls' shortest, median and longest seconds; the median call and
    # each call over 1.25 times it as [index, seconds, process CPU seconds,
    # GC seconds, involuntary context switches], to tell a host that
    # descheduled the process from work that grew; the window's collections
    line["call_s"] = [call_s[order[0]], call_s[mid], call_s[order[-1]]]
    line["median_call"] = described(mid)
    line["slow_calls"] = [described(k) for k in range(len(call_s))
                          if call_s[k] > 1.25 * call_s[mid]]
    launches = getattr(drive, "launches", [])[-len(calls):]
    line["k2_launches"] = sorted(set(launches))
    line["gc"] = collections.summary()
    line["power_limit"] = _power_limit() if on_card else None
    line["reference_s"] = reference_s
    line["checks"] = checks
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    tail = [f"power_limit {line['power_limit']}",
            f"reference_s {reference_s:.3f} calls {len(calls)}"]
    tail += [f"check {k} {v['value']} limit {v['limit']}" for k, v in checks.items()]
    return line, tail


def _usage(collections: "GcLog") -> tuple[float, float, int]:
    """The process's CPU seconds, its GC seconds so far and its involuntary
    context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, sum(collections.seconds.values()), ru.ru_nivcsw


class GcLog:
    """A ``gc.callbacks`` entry: each generation's collections and seconds."""

    def __init__(self):
        self.count, self.seconds, self._start = {}, {}, None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            g = str(info["generation"])
            self.count[g] = self.count.get(g, 0) + 1
            self.seconds[g] = self.seconds.get(g, 0.0) + time.perf_counter() - self._start
            self._start = None

    def summary(self) -> dict:
        return {g: [self.count[g], self.seconds[g]] for g in sorted(self.count)}


class ChipMissing(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("modules of JAX or of the JAX package were loaded: " + ", ".join(found))


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    reg = Registry()
    cell = reg.cell(args.workload)
    _set_environment(int(cell["chips"]))
    try:
        line, tail = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    except (ChipMissing, ForbiddenModules) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    for t in tail:
        print(t, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
