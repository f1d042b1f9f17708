"""The main path's public 1M ``search()`` in a fresh process: its first
call, its second, and a third with Python's cyclic GC off, each with the
seconds the GC spent inside it, its generation-2 collections and the
seconds of its adjacency sweep (``Search._ensure_adjacency``: the upload,
K2 + K3 and the decode; the rest is host work).

The first call of a process varies by tenths of a second with where the
GC's collections over the 1,000,000 ``VideoHash`` objects fall, so two
trees (say a commit and its parent) are compared over several processes
each, alternating, on one card:

    python tools/torch_first_search.py [--root DIR]

``--root`` names the checkout whose ``vid_dup_finder_lib_tpu_torch`` and
``chip_smoke.py`` (the 1M recipe) are imported (default: the checkout
that holds this file).  Needs a CUDA GPU.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_first_search: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import vid_dup_finder_lib_tpu_torch as vdf
    from vid_dup_finder_lib_tpu_torch.ops.hash_kernel import hash_cubes
    from vid_dup_finder_lib_tpu_torch.search import Search

    gc_s = [0.0, 0]
    t_gc = [0.0]

    def cb(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - t_gc[0]
            gc_s[1] += info["generation"] == 2

    gc.callbacks.append(cb)
    adjacency_s = [0.0]
    real_adjacency = Search._ensure_adjacency

    def timed_adjacency(self, *a, **kw):
        t0 = time.perf_counter()
        real_adjacency(self, *a, **kw)
        torch.cuda.synchronize()
        adjacency_s[0] += time.perf_counter() - t0

    Search._ensure_adjacency = timed_adjacency
    dev = torch.device("cuda")
    rng = np.random.default_rng(cs.SEED)
    cubes = torch.from_numpy(cs.make_cubes(rng)).to(dev)
    packed, durations, _ = cs.planted_library(cs.N_LIBRARY, cs.SEED)
    paths = [f"h{i:07d}" for i in range(cs.N_LIBRARY)]
    hash_cubes(cubes)  # the main path hashes first: the kernels are built and loaded
    hashes = vdf.VideoHash.many_from_packed_u32(packed, paths, durations)
    torch.cuda.synchronize()
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for name in ("first", "second", "third_gc_off"):
        if name == "third_gc_off":
            gc.disable()
        gc_s[:] = [0.0, 0]
        adjacency_s[0] = 0.0
        t0 = time.perf_counter()
        groups = vdf.search(hashes, cs.TOLERANCE, device=dev)
        torch.cuda.synchronize()
        out[name] = round(time.perf_counter() - t0, 4)
        out[name + "_gc_s"] = round(gc_s[0], 4)
        out[name + "_gen2"] = gc_s[1]
        out[name + "_adjacency_s"] = round(adjacency_s[0], 4)
        if len(groups) != cs.N_CLUSTERS:
            print(f"torch_first_search: {len(groups)} groups, {cs.N_CLUSTERS} planted", file=sys.stderr)
            return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
