"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, with one guarantee of the
configuration broken, has to come out as not correct.

The configuration guarantees the exact Hamming distance over all 1000
bits.  The control reads it over the first 992 (the hash's first 31
words, the step that would square the sweep's depth to whole words) and
is compared with the reference by the benchmark's own comparison.  Each
seed prints one JSON line with every number compared, its limit, and
whether the control failed it.

    python3 portbench/control.py --workload search_8m --seeds 11 12 13

On the card, at the cell's size: the reference and the control run on
card 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness, library, reference  # noqa: E402

CONTROL_BITS = 992
DEVICE = "cuda:0"


def control_readings(cfg: dict, seed: int, device) -> dict:
    lib = library.make_library(cfg, seed)
    args = (lib.packed, lib.durations, lib.paths_bytes, cfg["tolerance"],
            cfg["window_factor"], cfg["hash_bits"])
    t = time.perf_counter()
    want = reference.self_search_groups(*args, device=device)
    ref_s = time.perf_counter() - t
    got = reference.self_search_groups(*args, bits=CONTROL_BITS, device=device)
    planted = [tuple(p.decode() for p in lib.paths_bytes[list(g)].tolist()) for g in lib.planted]
    checks = harness.compare([got], want, planted)
    return {"seed": seed, "reference_s": ref_s, "reference_groups": len(want),
            "control_groups": len(got), "checks": checks,
            "control_correct": all(c["value"] <= c["limit"] for c in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    reg = harness.Registry()
    cfg = reg.config(reg.cell(args.workload)["config"])
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **control_readings(cfg, seed, DEVICE)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
