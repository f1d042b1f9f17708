"""``chip_smoke.py``'s ``ring_8m`` alone in a fresh process: the 8M library
resident on one card, swept by the ring on 4 shards of the card and by the
slabbed single-card sweep, ``reps`` times each, so that two trees (say a
commit and its parent) can be compared on one card without the phases that
run before ``ring_8m`` in ``chip_smoke.py``:

    python tools/torch_ring_8m.py [--root DIR] [--reps N]

``--root`` names the checkout whose ``vid_dup_finder_lib_tpu_torch`` and
``chip_smoke.py`` (the 8M recipe and its tolerance) are imported (default:
the checkout that holds this file).  Every run must find the 600 planted
pairs.  Needs a CUDA GPU.  Prints one JSON object: the ring's wall seconds
and its ``sweep`` phase, and the slabbed sweep's wall seconds, per run (the
first run of each includes its first use on the card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_ring_8m: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda")
    packed, durations, starts = cs.planted_library(cs.N_SCALE, cs.SEED)
    bounds = cs.self_bounds(durations)
    want = len(cs.planted_pairs(starts)[0])
    lib = hc.IncrementalDeviceLibrary(dev, capacity=cs.N_SCALE)
    for part in np.array_split(packed, cs.LIBRARY_CHUNKS):
        lib.append(part)
    state = lib.state(np.arange(cs.N_SCALE), bounds)
    torch.cuda.synchronize()
    out = {"root": root, "device": torch.cuda.get_device_name(0), "ring_s": [],
           "ring_sweep_s": [], "slabbed_s": []}
    for _ in range(args.reps):
        t0 = time.perf_counter()
        ring = ring_cuda.banded_adjacency_ring(lib.packed, bounds, cs.TOL_INT, mesh=Mesh([dev] * 4),
                                               n=cs.N_SCALE)
        torch.cuda.synchronize()
        out["ring_s"].append(round(time.perf_counter() - t0, 4))
        out["ring_sweep_s"].append(round(ring_cuda.LAST_RING_PHASES["sweep"], 4))
        t0 = time.perf_counter()
        slabbed = hc.banded_adjacency_cuda(state, cs.TOL_INT)
        torch.cuda.synchronize()
        out["slabbed_s"].append(round(time.perf_counter() - t0, 4))
        if not len(ring[0]) == len(slabbed[0]) == want:
            print(f"torch_ring_8m: {len(ring[0])} and {len(slabbed[0])} pairs, {want} planted",
                  file=sys.stderr)
            return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
