"""What the port's span recorder (``utils/timers.py``) costs while on.

Two readings, in one process on one card:

* one ``span()`` entered and left, while off (no profiler) and while on
  (under a ``torch.profiler`` of the CPU and the card, where each span
  also opens a ``record_function``), in ns per span, over many spans;
* the public ``search()`` over the benchmark's ``library_8m`` library
  (``portbench/library.py``, from ``--seed``; ``--hashes`` cuts it), all
  under one profiler of the CPU and the card, alternately with the
  recorder on (spans recorded) and with its flag read as off (the same
  profiler, no spans): each call's wall seconds, synchronised, and the
  spans one search records.

    python tools/torch_span_cost.py [--hashes N] [--seed S] [--pairs K]

Needs a CUDA GPU.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_span_ns(timers, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with timers.span("search.sweep"):
            pass
    return (time.perf_counter_ns() - t0) / n


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hashes", type=int, default=None)
    p.add_argument("--seed", type=int, default=2**31 + 101)
    p.add_argument("--pairs", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_span_cost: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from portbench import harness, library
    from vid_dup_finder_lib_tpu_torch import VideoHash, search
    from vid_dup_finder_lib_tpu_torch.utils import timers

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"device": torch.cuda.get_device_name(0)}
    per_span_ns(timers, 10_000)
    out["span_off_ns"] = per_span_ns(timers, 1_000_000)
    with profile(activities=acts):
        per_span_ns(timers, 1_000)
        out["span_on_ns"] = per_span_ns(timers, 20_000)
    timers.drain()

    cfg = harness.Registry().config("library_8m")
    if args.hashes:
        cfg["hashes"] = args.hashes
    lib = library.make_library(cfg, args.seed)
    batch = VideoHash.many_from_packed_u32(lib.packed, lib.paths(), lib.durations)
    search(batch, cfg["tolerance"])  # warm: the kernels built and loaded
    torch.cuda.synchronize()
    real = timers._profiler
    off = types.SimpleNamespace(_is_profiler_enabled=False)
    walls = {"on": [], "off": []}
    spans_per_search = []
    order = ["on", "off", "off", "on"] * args.pairs
    with profile(activities=acts):
        for side in order[: 2 * args.pairs]:
            timers._profiler = real if side == "on" else off
            try:
                t0 = time.perf_counter()
                search(batch, cfg["tolerance"])
                torch.cuda.synchronize()
                walls[side].append(time.perf_counter() - t0)
            finally:
                timers._profiler = real
            if side == "on":
                spans_per_search.append(len(timers.drain()))
    out.update(hashes=int(cfg["hashes"]), seed=args.seed, order=order[: 2 * args.pairs],
               wall_on_s=walls["on"], wall_off_s=walls["off"],
               median_on_s=statistics.median(walls["on"]),
               median_off_s=statistics.median(walls["off"]),
               spans_per_search=spans_per_search)
    out["cost_ms"] = 1000 * (out["median_on_s"] - out["median_off_s"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
