"""The port's multi-device layer against one card, on chip_smoke's recipes:
``banded_adjacency_ring`` over a mesh with its blocks cut at equal work
(``ring``, the package's cut) and at equal rows (``ring_equal_rows``, the
cut of the JAX package's SPMD ring, which the port took before), beside
the one-card sweep (``one_card``: ``SearchState`` from the same host
matrix); then the 10k x n references (``tools/bench_refs.py``'s recipe)
split over the mesh, both ways (``refs``, ``refs_equal_rows``), against
one card's ``RefsState`` sweep (``refs_one_card``).

    python tools/torch_ring_cards.py [--n N ...] [--reps 3] [--shards 4] [--root DIR]

The mesh is every visible card (at most ``--shards``, one shard each)
where two or more are visible, else ``--shards`` shards of ``cuda:0``,
which run in turn, so the ring's per-(shard, step) seconds project its
wall on distinct cards (``projected_wall_s``: a barrier after each step;
``projected_free_s``: none).  For each library size the runs alternate in
order from one repetition to the next (forward, then backward), and every
run's pairs must equal the one-card sweep's; the self-search must find
every planted pair.  ``--root`` names the checkout whose package and
``chip_smoke.py`` are imported (default: this file's); a package without
``ring_cuda.prefix_cuts`` (whose ring cuts equal rows) runs ``ring`` and
``refs`` as they are.

Prints one JSON object first (the cards' names and power limits,
``nvidia-smi topo -m``, and from the first card to each other one peer
access and a copy's rate), then one per run (seconds with every card
synchronised, each card's summed sweep seconds, ``LAST_RING_PHASES``),
then one of medians per size.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time


def smi(*args: str) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, nargs="+", default=[1_000_000, 8_000_000])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--no-refs", action="store_true", help="the self-search only")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_ring_cards: needs a CUDA GPU", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = Mesh([torch.device("cuda", i) for i in range(min(args.shards, cards))])
    else:
        mesh = Mesh([torch.device("cuda", 0)] * args.shards)
    print(json.dumps({"root": root, "mesh": repr(mesh), "torch": torch.__version__,
                      "cards": smi("--query-gpu=index,name,power.limit", "--format=csv,noheader"),
                      "topology": smi("topo", "-m"), **link(list(dict.fromkeys(mesh)))}), flush=True)
    for n in args.n:
        if run_size(cs, mesh, n, args.reps, not args.no_refs):
            return 1
    return 0


def link(cards, nbytes: int = 256 * 2**20, reps: int = 5) -> dict:
    """Between the first card and each other one: whether it may access
    the other's memory directly (peer to peer), and the rate of a copy of
    ``nbytes`` to it (GB/s, CUDA events on the first card's stream, the
    mean of ``reps`` copies after one more)."""
    import torch

    out = {"peer_access": {}, "copy_gb_per_s": {}}
    src = torch.empty(nbytes, dtype=torch.uint8, device=cards[0])
    stream = torch.cuda.current_stream(cards[0])
    for dst in cards[1:]:
        out["peer_access"][f"{cards[0]}->{dst}"] = torch.cuda.can_device_access_peer(
            cards[0].index, dst.index)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dst)
        buf.copy_(src)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        for _ in range(reps):
            buf.copy_(src)
        end.record(stream)
        end.synchronize()
        out["copy_gb_per_s"][f"{cards[0]}->{dst}"] = nbytes * reps / (start.elapsed_time(end) * 1e6)
    return out


def equal_rows(work, n_dev: int):
    """Block starts at equal rows: ``ceil(n / n_dev)`` rounded up to the
    128-row tile, the cut the ring took before it cut by work."""
    import numpy as np

    n = len(work)
    ns = -(-(-(-n // n_dev)) // 128) * 128
    return np.unique(np.minimum(np.arange(n_dev + 1) * ns, n))


@contextlib.contextmanager
def cut_by_rows(ring_cuda):
    """The ring and the references search (both cut through
    ``ring_cuda.prefix_cuts``) cut at equal rows meanwhile."""
    saved = ring_cuda.prefix_cuts
    ring_cuda.prefix_cuts = equal_rows
    try:
        yield
    finally:
        ring_cuda.prefix_cuts = saved


def refs_case(cs, n: int):
    """``tools/bench_refs.py``'s recipe over ``n`` candidates:
    ``chip_smoke.refs_inputs``' construction, 10,000 references."""
    import numpy as np

    rng = np.random.default_rng(cs.SEED)
    cand_durs = np.sort(rng.integers(30, 7200, n))
    ref_durs = np.sort(rng.integers(30, 7200, cs.N_REFS))
    lo = np.searchsorted(cand_durs, (ref_durs * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(cand_durs, (ref_durs * 1.05).astype(np.int64), "right")
    refs = rng.integers(0, 2**32, (cs.N_REFS, 32), dtype=np.uint64).astype(np.uint32)
    cands = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    for k in range(0, cs.N_REFS, cs.REFS_PLANT_EVERY):
        if hi[k] > lo[k]:
            refs[k] = cands[lo[k]]
    return refs, cands, lo, hi


def run_size(cs, mesh, n: int, reps: int, with_refs: bool) -> int:
    import numpy as np
    import torch

    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.parallel import refs_sharded as rs
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda

    dev = mesh[0]
    t0 = time.perf_counter()
    packed, durations, starts = cs.planted_library(n, cs.SEED)
    bounds = cs.self_bounds(durations)
    planted = cs.planted_pairs(starts)
    runs = {
        "one_card": lambda: hc.banded_adjacency_cuda(hc.SearchState(packed, bounds, dev), cs.TOL_INT),
        "ring": lambda: ring_cuda.banded_adjacency_ring(packed, bounds, cs.TOL_INT, mesh=mesh),
    }
    by_rows = hasattr(ring_cuda, "prefix_cuts")
    if by_rows:
        def ring_equal_rows():
            with cut_by_rows(ring_cuda):
                got = ring_cuda.banded_adjacency_ring(packed, bounds, cs.TOL_INT, mesh=mesh)
            if ring_cuda.LAST_RING_PHASES["cuts"] != equal_rows(bounds, mesh.size).tolist():
                raise RuntimeError("ring_equal_rows: the ring did not cut at equal rows")
            return got
        runs["ring_equal_rows"] = ring_equal_rows
    if with_refs:
        refs, cands, lo, hi = refs_case(cs, n)
        runs["refs_one_card"] = lambda: hc.refs_adjacency_cuda(
            hc.RefsState(refs, cands, lo, hi, dev), cs.TOL_INT)
        runs["refs"] = lambda: rs.refs_adjacency_sharded(
            refs, lo, hi, cs.TOL_INT, cands_packed=cands, mesh=mesh)
        if by_rows:
            def refs_equal_rows():
                with cut_by_rows(ring_cuda):
                    return rs.refs_adjacency_sharded(
                        refs, lo, hi, cs.TOL_INT, cands_packed=cands, mesh=mesh)
            runs["refs_equal_rows"] = refs_equal_rows
    make_s = time.perf_counter() - t0

    def sync():
        for d in dict.fromkeys(mesh):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # first use: builds the kernels and launches once on every card
    want = {name: runs[name]() for name in ("one_card", "refs_one_card") if name in runs}
    if not cs.same_pairs(want["one_card"], planted):
        print(f"torch_ring_cards: one card found {len(want['one_card'][0])} pairs at n={n},"
              f" {len(planted[0])} planted", file=sys.stderr)
        return 1
    for name in runs:
        if name not in want:
            runs[name]()
    seconds: dict[str, list[float]] = {name: [] for name in runs}
    walls: dict[str, list[float]] = {}
    for rep in range(reps):
        for name in (list(runs) if rep % 2 == 0 else list(runs)[::-1]):
            sync()
            t0 = time.perf_counter()
            got = runs[name]()
            sync()
            s = time.perf_counter() - t0
            if not cs.same_pairs(got, want["refs_one_card" if name.startswith("refs") else "one_card"]):
                print(f"torch_ring_cards: {name} pairs differ from one card's at n={n}", file=sys.stderr)
                return 1
            seconds[name].append(s)
            line = {"n": n, "rep": rep, "run": name, "seconds": s, "pairs": len(got[0])}
            if name.startswith("ring"):
                ph = ring_cuda.LAST_RING_PHASES
                line["phases"] = ph
                if "shard_s" in ph:
                    card_s: dict[str, float] = {}
                    for d, per_step in enumerate(ph["shard_s"]):
                        card_s[str(mesh[d])] = card_s.get(str(mesh[d]), 0.0) + sum(per_step)
                    line["card_s"] = card_s
                    for key in ("projected_wall_s", "projected_free_s"):
                        walls.setdefault(f"{name}_{key}", []).append(ph[key])
            print(json.dumps(line), flush=True)
    med = {k: statistics.median(v) for k, v in seconds.items()}
    out = {"n": n, "make_library_s": make_s, "mesh": repr(mesh), "median_s": med,
           "spread_s": {k: max(v) - min(v) for k, v in seconds.items()},
           "median_projected_s": {k: statistics.median(v) for k, v in walls.items()}}
    for name in med:
        base = "refs_one_card" if name.startswith("refs") else "one_card"
        if name != base:
            out[f"{name}_vs_one_card"] = med[name] / med[base]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
