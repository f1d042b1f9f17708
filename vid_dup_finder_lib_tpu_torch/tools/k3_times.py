"""K3 (``band_pack_kernel``) of one checkout, timed where phase B is small
and where it is not, so that two trees (say a commit and its parent) can be
compared on one card:

    python vid_dup_finder_lib_tpu_torch/tools/k3_times.py [--root DIR]

``--root`` names the checkout whose ``vid_dup_finder_lib_tpu_torch`` is
imported and whose kernels are built (default: the one that holds this
file).  The libraries and the timing are ``chip_smoke.py``'s, of the
checkout that holds this file: the 1M library's own hit list, the dense
library's, and every band tile of a run of row tiles in the middle of the
1M library.  Each is timed queued behind a long kernel (the launches run
back to back, the wrapper's host work is hidden) and held word for word to
the plain version (1 tile in 31 of the long list).  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def k3_report(hc, smoke, device: torch.device) -> dict:
    """Times and checks of ``hc.band_pack`` on ``smoke``'s libraries."""
    packed, durations, _ = smoke.planted_library(smoke.N_LIBRARY, smoke.SEED)
    state = hc.SearchState(packed, smoke.self_bounds(durations), device)
    dense = hc.SearchState(*smoke.dense_library(np.random.default_rng(smoke.SEED)), device)
    tol = smoke.TOL_INT
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lists = {
        "sparse_1m": (state, hc.hit_tiles(state, hc.band_counts(state, tol)), 1),
        "dense": (dense, hc.hit_tiles(dense, hc.band_counts(dense, tol)), 1),
        "full": (state, smoke.band_tiles(hc, state, state.n_row_tiles // 2,
                                         smoke.FULL_LIST_TILES), smoke.FULL_LIST_SAMPLE),
    }
    out = {}
    for name, (st, hits, step) in lists.items():
        sample = torch.arange(0, hits.shape[0], step, device=device)
        err = smoke.bit_diff(hc.band_pack(st, hits, tol)[sample],
                             hc.band_pack_plain(st, hits[sample], tol))
        ms = smoke.queued_ms(lambda: hc.band_pack(st, hits, tol),
                             lambda: hc.band_counts(state, tol))
        out[name] = dict(hit_tiles=hits.shape[0], queued_ms=ms, max_abs_err=err,
                         us_per_tile_per_sm=ms * 1e3 * sms / hits.shape[0])
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE, help="checkout whose port is measured")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_times: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc

    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    report = k3_report(hc, smoke, torch.device("cuda"))
    bad = {k: v["max_abs_err"] for k, v in report.items() if v["max_abs_err"]}
    print(json.dumps(dict(root=root, device=torch.cuda.get_device_name(0), **report)))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
