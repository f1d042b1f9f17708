"""K1, K2 and K4 of one checkout, timed alone in a fresh process, so that
two trees (say a commit and its parent) can be compared on one card
without the rest of ``chip_smoke.py`` around them:

    python tools/torch_kernel_times.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``vid_dup_finder_lib_tpu_torch`` and
``chip_smoke.py`` (the inputs: its 65,536 cubes and its 1M library at its
tolerance) are imported (default: the checkout that holds this file).
Each kernel runs once to warm up, then ``reps`` times back to back between
two CUDA events: K1 on the cubes, K2 over the 1M state, K4 over all of its
ranges.  The card's SM clock and temperature are read by ``nvidia-smi``
before and after.  Needs a CUDA GPU.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.ops.hash_kernel import hash_cubes

    dev = torch.device("cuda")
    cubes = torch.from_numpy(cs.make_cubes(np.random.default_rng(cs.SEED))).to(dev)
    packed, durations, _ = cs.planted_library(cs.N_LIBRARY, cs.SEED)
    state = hc.SearchState(packed, cs.self_bounds(durations), dev)
    ranges = hb.band_ranges(state)
    kernels = {
        "k1_ms": lambda: hash_cubes(cubes),
        "k2_ms": lambda: hc.band_counts(state, cs.TOL_INT),
        "k4_ms": lambda: [hb.band_sweep(state, cs.TOL_INT, a, b) for a, b in ranges],
    }
    out = {"root": root, "device": torch.cuda.get_device_name(0), "card_before": _card()}
    for name, fn in kernels.items():
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        out[name] = round(start.elapsed_time(end) / args.reps, 4)
    out["card_after"] = _card()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
