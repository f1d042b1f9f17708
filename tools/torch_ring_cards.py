"""The port's multi-device layer over distinct cards, beside one card, on
chip_smoke's 1M recipe: ``banded_adjacency_ring`` over every visible card
(at most 4, one shard each) and over 4 shards of ``cuda:0``, and the
one-card sweep (``SearchState`` from the same host matrix); then the 10k x
1M references split over the cards against one card's ``RefsState`` sweep.
The runs alternate in order from one repetition to the next; every run's
pairs must equal the one-card sweep's.

    python tools/torch_ring_cards.py [--reps 3]

Needs at least two CUDA GPUs.  Prints one JSON object per run (seconds,
all cards synchronised, and ``LAST_RING_PHASES``), then one of medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"torch_ring_cards: needs 2 CUDA GPUs, this host has {cards}", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh
    from vid_dup_finder_lib_tpu_torch.parallel.refs_sharded import refs_adjacency_sharded

    dev = torch.device("cuda", 0)
    devices = [torch.device("cuda", i) for i in range(min(4, cards))]
    packed, durations, _ = cs.planted_library(cs.N_LIBRARY, cs.SEED)
    bounds = cs.self_bounds(durations)
    refs, _, cands, _, lo, hi, _ = cs.refs_inputs(cs.SEED)
    runs = {
        "one_card": lambda: hc.banded_adjacency_cuda(hc.SearchState(packed, bounds, dev), cs.TOL_INT),
        "ring_cards": lambda: ring_cuda.banded_adjacency_ring(
            packed, bounds, cs.TOL_INT, mesh=Mesh(devices)),
        "ring_4_shards_one_card": lambda: ring_cuda.banded_adjacency_ring(
            packed, bounds, cs.TOL_INT, mesh=Mesh([dev] * 4)),
        "refs_one_card": lambda: hc.refs_adjacency_cuda(hc.RefsState(refs, cands, lo, hi, dev), cs.TOL_INT),
        "refs_cards": lambda: refs_adjacency_sharded(
            refs, lo, hi, cs.TOL_INT, cands_packed=cands, mesh=Mesh(devices)),
    }

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    want = {name: runs[name]() for name in ("one_card", "refs_one_card")}  # builds the kernels
    runs["ring_cards"]()  # and launches once on every card
    out = {"device": torch.cuda.get_device_name(0), "cards": len(devices), "mesh": repr(Mesh(devices))}
    seconds: dict[str, list[float]] = {name: [] for name in runs}
    for rep in range(args.reps):
        order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
        for name in order:
            sync()
            t0 = time.perf_counter()
            got = runs[name]()
            sync()
            s = time.perf_counter() - t0
            ref = want["refs_one_card" if name.startswith("refs") else "one_card"]
            if not (np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])):
                print(f"torch_ring_cards: {name} pairs differ from one card's", file=sys.stderr)
                return 1
            seconds[name].append(s)
            line = {"rep": rep, "run": name, "seconds": round(s, 4), "pairs": len(got[0])}
            if name.startswith("ring"):
                line["phases"] = {k: round(v, 4) if isinstance(v, float) else v
                                  for k, v in ring_cuda.LAST_RING_PHASES.items()}
            print(json.dumps(line))
    out["median_s"] = {k: round(statistics.median(v), 4) for k, v in seconds.items()}
    out["ring_cards_vs_one_card"] = round(out["median_s"]["ring_cards"] / out["median_s"]["one_card"], 3)
    out["refs_cards_vs_one_card"] = round(
        out["median_s"]["refs_cards"] / out["median_s"]["refs_one_card"], 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
