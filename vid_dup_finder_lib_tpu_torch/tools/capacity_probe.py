"""How large a library one card sweeps, and what each sweep holds in memory:

    python vid_dup_finder_lib_tpu_torch/tools/capacity_probe.py \
        [--sizes 2000000,4000000,...] [--limit-s 120] [--out FILE]

For each size n (default 2M, 4M, 8M, 16M, 32M) it builds ``chip_smoke.py``'s
planted library of n hashes (seed 0, durations 30-7200 s, 200 clusters of 3
at radius 60), uploads it as one :class:`SearchState`, and runs three
sweeps at tolerance 350:

* ``one_state``: the two-phase sweep (K2 + K3) with one dense counts buffer
  for the whole library (a counts budget nothing exceeds), the sweep as it
  was before it walked slabs;
* ``slabbed``: the same sweep under the default ``COUNTS_BUDGET``;
* ``band``: the whole-band sweep (K4) in its word ranges.

Per sweep: wall seconds, in-band pairs per second, peak device memory above
the resident library, the largest counts buffer in bytes, slabs or ranges,
kernel launches, and the pairs found beside the pairs planted; a sweep that
raises is recorded with the exception's text.  A sweep leaves the later
sizes once it failed or once four times its seconds (the in-band pairs grow
with n squared) pass ``--limit-s``; the probe ends when none is left.  One
JSON line per size, each with the card's name and power limit; ``--out``
also appends them to a file.  Exit code 1 if a sweep found other pairs than
were planted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_SIZES = (2_000_000, 4_000_000, 8_000_000, 16_000_000, 32_000_000)
NO_BUDGET = 1 << 62  # a counts budget no library reaches: one slab


def measure(fn, counters, device) -> dict:
    """Run ``fn`` with the launch counts at 0 and the peak memory reset:
    its seconds, its peak above what was allocated before it, its launches,
    and its result or the text of what it raised."""
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = dict(ok=True)
    t0 = time.perf_counter()
    try:
        result = fn()
        torch.cuda.synchronize(device)
    except Exception as e:  # the probe's purpose: record what fails, and go on
        result = None
        out.update(ok=False, error=f"{type(e).__name__}: {e}"[:500])
    out["seconds"] = time.perf_counter() - t0
    out["peak_bytes_above_library"] = torch.cuda.max_memory_allocated(device) - base
    out["launches"] = {c.__name__: c.launches for c in counters}
    if not out["ok"]:
        torch.cuda.empty_cache()
    return out | dict(result=result)


def probe_size(n, hc, hb, smoke, device, modes) -> dict:
    """One size's record; ``modes`` maps each sweep still running to None,
    and gets its seconds (or None after a failure)."""
    t0 = time.perf_counter()
    packed, durations, starts = smoke.planted_library(n, smoke.SEED)
    bounds = smoke.self_bounds(durations)
    want = smoke.planted_pairs(starts)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = hc.SearchState(packed, bounds, device)
    torch.cuda.synchronize(device)
    upload_s = time.perf_counter() - t0
    del packed
    comps = state.comparisons()
    tol = smoke.TOL_INT
    counters = (hc.band_counts, hc.band_pack, hb.band_sweep)
    slabs = hc.count_slabs(state)
    cells = lambda ss: max((b - a) * int(state.n_ct[a:b].max(initial=0)) for a, b in ss)
    sweeps = {
        "one_state": (lambda: hc.banded_adjacency_cuda(state, tol, counts_budget=NO_BUDGET),
                      dict(slabs=1, counts_bytes=4 * state.n_row_tiles * state.slots)),
        "slabbed": (lambda: hc.banded_adjacency_cuda(state, tol),
                    dict(slabs=len(slabs), counts_bytes=4 * cells(slabs))),
        "band": (lambda: hb.banded_adjacency_band(None, None, tol, state=state),
                 dict(ranges=len(hb.band_ranges(state)))),
    }
    rec = dict(n=n, library_bytes=state.packed.numel() * 4, row_tiles=state.n_row_tiles,
               slots=state.slots, band_tiles=int(state.n_ct.sum()), comparisons=comps,
               planted_pairs=len(want[0]), make_library_s=make_s, state_upload_s=upload_s)
    for name in list(modes):
        fn, facts = sweeps[name]
        m = measure(fn, counters, device)
        result = m.pop("result")
        m.update(facts, comps_per_s=comps / m["seconds"] if m["ok"] else None)
        if m["ok"]:
            m["pairs"] = len(result[0])
            m["pairs_equal_planted"] = bool(
                np.array_equal(result[0], want[0]) and np.array_equal(result[1], want[1]))
        modes[name] = m["seconds"] if m["ok"] else None
        rec[name] = m
        del result
    return rec


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", default=",".join(map(str, DEFAULT_SIZES)))
    p.add_argument("--limit-s", type=float, default=120.0,
                   help="a sweep projected past this many seconds at the next size stops")
    p.add_argument("--out", help="file the JSON lines are appended to as well")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("capacity_probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.utils import cuda_build

    device = torch.device("cuda")
    cuda_build.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    modes: dict = {"one_state": None, "slabbed": None, "band": None}
    wrong = False
    for n in (int(x) for x in args.sizes.split(",")):
        rec = probe_size(n, hc, hb, smoke, device, modes)
        rec.update(card=smi, device_bytes=torch.cuda.get_device_properties(device).total_memory)
        stopped = {}
        for name, seconds in list(modes.items()):
            if seconds is None or 4 * seconds > args.limit_s:
                stopped[name] = "failed" if seconds is None else (
                    f"next size projected at {4 * seconds:.1f} s")
                del modes[name]
        rec["stopped_after_this_size"] = stopped
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        wrong |= any(rec[m].get("pairs_equal_planted") is False
                     for m in ("one_state", "slabbed", "band") if m in rec)
        if not modes:
            break
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
