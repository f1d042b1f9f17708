"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (batch hash -> banded search -> groups) on
``cuda`` at a 1,000,000-hash library, builds every CUDA kernel of that
path from ``vid_dup_finder_lib_tpu_torch/csrc``, and holds each kernel to
its plain PyTorch version on the same inputs.  Any mismatch raises and the
script exits non-zero.  It refuses to run without CUDA.

Output: one progress line per phase; then a JSON line with each kernel's
launch count in the main-path run, its largest disagreement with the plain
version, and both times; then the card's name and power limit from
nvidia-smi; last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
N_LIBRARY = 1_000_000
N_CLUSTERS = 200  # planted duplicate clusters in the 1M library
CLUSTER_SIZE = 3
CLUSTER_RADIUS = 60  # bit flips from the cluster seed: pairwise <= 120
TOLERANCE = 0.35  # search() tolerance; 350 in the integer Hamming domain
TOL_INT = 350
N_CUBES = 65_536
N_GOLDEN = 512
REPO = os.path.dirname(os.path.abspath(__file__))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **kv) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` in ms (CUDA events), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_cubes(rng: np.random.Generator) -> np.ndarray:
    """Half uniform, half low-contrast (128 +/- 2) cubes; the first 512
    are 256 of each, the corpus the golden-model test pins."""
    half = N_CUBES // 2
    uni = rng.integers(0, 256, (half, 16, 16, 16), dtype=np.uint8)
    low = (128 + rng.integers(-2, 3, (half, 16, 16, 16))).astype(np.uint8)
    k = N_GOLDEN // 2
    return np.concatenate([uni[:k], low[:k], uni[k:], low[k:]])


def flip_bits(h: np.ndarray, rng, count: int) -> np.ndarray:
    h = h.copy()
    for f in rng.choice(1000, count, replace=False):
        h[f // 32] ^= np.uint32(1) << np.uint32(f % 32)
    return h


def planted_library(n: int, seed: int):
    """Random duration-sorted library with planted 3-hash clusters, pad
    bits masked (the recipe of bench.py's synth_library)."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(30, 7200, n))
    starts = rng.choice(n // 8 - 1, N_CLUSTERS, replace=False) * 8
    for s in starts:
        for k in range(1, CLUSTER_SIZE):
            packed[s + k] = flip_bits(packed[s], rng, CLUSTER_RADIUS)
            durations[s + k] = durations[s]
    return packed, durations, starts


def self_bounds(durations: np.ndarray) -> np.ndarray:
    thresh = (durations.astype(np.float64) * 1.1).astype(np.int64)
    return np.searchsorted(durations, thresh, side="right")


def dense_library(rng):
    """65,536 hashes in 2,048 clusters of 32 at shared durations (~1M
    in-tolerance pairs, many hit tiles)."""
    n_cl, size = 2048, 32
    seeds = rng.integers(0, 2**32, (n_cl, 32), dtype=np.uint64).astype(np.uint32)
    seeds[:, -1] &= np.uint32(0xFF)
    packed = np.empty((n_cl * size, 32), np.uint32)
    for c in range(n_cl):
        for k in range(size):
            packed[c * size + k] = flip_bits(seeds[c], rng, 40)
    durations = np.repeat(np.sort(rng.integers(30, 7200, n_cl)), size)
    return packed, self_bounds(durations)


def pad_bit_library(rng):
    """4,096 hashes with random nonzero pad bits and planted pairs."""
    n = 4096
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] |= np.uint32(1 << 31)  # a pad bit is set in every row
    durations = np.sort(rng.integers(30, 7200, n))
    for s in range(0, n - 1, 97):
        packed[s + 1] = flip_bits(packed[s], rng, 60)
        durations[s + 1] = durations[s]
    return packed, self_bounds(durations)


def groups_as_sets(groups) -> set:
    return {frozenset(os.path.basename(p) for p in g.contained_paths()) for g in groups}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a"
              " CUDA GPU", file=sys.stderr)
        return 1
    import vid_dup_finder_lib_tpu_torch as vdf
    from vid_dup_finder_lib_tpu_torch.ingest import available_backends
    from vid_dup_finder_lib_tpu_torch.models.pipeline import hash_videos
    from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
    from vid_dup_finder_lib_tpu_torch.ops.golden import hash_bits_golden
    from vid_dup_finder_lib_tpu_torch.ops.hamming import banded_adjacency
    from vid_dup_finder_lib_tpu_torch.ops.hash_kernel import (
        hash_cubes,
        hash_cubes_plain,
    )
    from vid_dup_finder_lib_tpu_torch.utils import cuda_build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), smi=repr(smi))

    t0 = time.perf_counter()
    cuda_build.load_library()
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          nvcc_seconds=round(cuda_build.BUILD_INFO["seconds"], 3),
          lib=os.path.relpath(cuda_build.BUILD_INFO["path"], REPO))

    rng = np.random.default_rng(SEED)
    cubes_np = make_cubes(rng)
    packed, durations, starts = planted_library(N_LIBRARY, SEED)
    paths = [f"h{i:07d}" for i in range(N_LIBRARY)]
    planted = {frozenset(paths[s + k] for k in range(CLUSTER_SIZE)) for s in starts}
    cubes = torch.from_numpy(cubes_np).to(dev)
    torch.cuda.synchronize()
    phase("inputs", cubes=N_CUBES, library=N_LIBRARY, planted_groups=len(planted))

    # ---- the main path, counted: batch hash, then the public search at 1M
    counters = (hash_cubes, hc.band_counts, hc.band_pack)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    words = hash_cubes(cubes)
    hashes = vdf.VideoHash.many_from_packed_u32(packed, paths, durations)
    groups = vdf.search(hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    found = groups_as_sets(groups)
    require(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    require(found == planted, f"1M search found {len(found)} groups, "
            f"{len(found & planted)} of the {len(planted)} planted")
    phase("main_path", seconds=round(e2e_s, 3), groups=len(found),
          planted_found=len(found & planted), launches=json.dumps(launches))

    # ---- K1: hash kernel vs plain (card) and vs the f64 golden model
    plain = hash_cubes_plain(cubes)
    diff = np.bitwise_count((words ^ plain).cpu().numpy().view(np.uint32)).sum(1)
    require(int(diff.max()) <= 2, f"kernel vs plain: {int(diff.max())} bits in one hash")
    require(int(diff.sum()) <= 1e-4 * N_CUBES * 1000,
            f"kernel vs plain: {int(diff.sum())} flipped bits")
    wk = words[:N_GOLDEN].cpu().numpy().view(np.uint32)
    gold = [
        int((hash_bits_golden(cubes_np[i])
             != vdf.VideoHash.from_packed_u32(wk[i]).hash_bits()).sum())
        for i in range(N_GOLDEN)
    ]
    require(max(gold) <= 2 and sum(gold) <= 8,
            f"kernel vs golden: worst {max(gold)}, total {sum(gold)}")
    k1_ms = cuda_ms(lambda: hash_cubes(cubes))
    k1_plain_ms = cuda_ms(lambda: hash_cubes_plain(cubes))
    phase("hash", bound=repr("vs plain <=2 bits/hash, <=1e-4 of bits; vs golden <=2/hash, <=8 total"),
          vs_plain_bits=int(diff.sum()), vs_plain_worst=int(diff.max()),
          vs_golden_bits=sum(gold), vs_golden_worst=max(gold),
          kernel_ms=round(k1_ms, 3), plain_ms=round(k1_plain_ms, 3),
          hashes_per_s=f"{N_CUBES / (k1_ms / 1e3):.4g}")

    # ---- K2 + K3 at 1M: kernels vs plain versions, tile by tile and pairs
    bounds = self_bounds(durations)
    state = hc.SearchState(packed, bounds, dev)
    comps = state.comparisons()
    ck = hc.band_counts(state, TOL_INT)
    cp = hc.band_counts_plain(state, TOL_INT)
    k2_err = int((ck - cp).abs().max())
    require(k2_err == 0, f"band counts differ by up to {k2_err}")
    hits = hc.hit_tiles(state, cp)
    wk3 = hc.band_pack(state, hits, TOL_INT)
    wp3 = hc.band_pack_plain(state, hits, TOL_INT)
    k3_err = int(np.bitwise_count((wk3 ^ wp3).cpu().numpy().view(np.uint32)).max(initial=0))
    require(k3_err == 0, f"packed words differ by up to {k3_err} bits")
    k2_ms = cuda_ms(lambda: hc.band_counts(state, TOL_INT))
    k2_plain_ms = cuda_ms(lambda: hc.band_counts_plain(state, TOL_INT), reps=3)
    k3_ms = cuda_ms(lambda: hc.band_pack(state, hits, TOL_INT))
    k3_plain_ms = cuda_ms(lambda: hc.band_pack_plain(state, hits, TOL_INT))
    t0 = time.perf_counter()
    ki, kj = hc.banded_adjacency_cuda(state, TOL_INT)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pi, pj = hc.banded_adjacency_plain(state, TOL_INT)
    sweep_plain_s = time.perf_counter() - t0
    require(np.array_equal(ki, pi) and np.array_equal(kj, pj),
            f"1M pairs: kernel {len(ki)} vs plain {len(pi)}")
    phase("search_1m", bound="exact", comparisons=comps, pairs=len(ki), hit_tiles=hits.shape[0],
          sweep_s=round(sweep_s, 4), sweep_plain_s=round(sweep_plain_s, 4),
          comps_per_s=f"{comps / sweep_s:.4g}",
          counts_ms=round(k2_ms, 3), counts_plain_ms=round(k2_plain_ms, 3),
          pack_ms=round(k3_ms, 3), pack_plain_ms=round(k3_plain_ms, 3),
          launches=json.dumps({fn.__name__: fn.launches for fn in counters}))

    # ---- dense phase B and nonzero pad bits
    for name, (lib, lb) in (("dense", dense_library(rng)),
                            ("pad_bits", pad_bit_library(rng))):
        st = hc.SearchState(lib, lb, dev)
        ki, kj = hc.banded_adjacency_cuda(st, TOL_INT)
        pi, pj = hc.banded_adjacency_plain(st, TOL_INT)
        require(np.array_equal(ki, pi) and np.array_equal(kj, pj),
                f"{name}: kernel {len(ki)} pairs vs plain {len(pi)}")
        if name == "pad_bits":
            hi, hj = banded_adjacency(lib, lb, TOL_INT, backend="host")
            require(np.array_equal(ki, hi) and np.array_equal(kj, hj),
                    f"{name}: kernel {len(ki)} pairs vs host {len(hi)}")
        require(len(ki) > 0, f"{name}: no pairs")
        phase(name, hashes=lib.shape[0], pairs=len(ki), hit_tiles=int(
            (hc.band_counts(st, TOL_INT) > 0).sum()))

    # ---- real content: the frozen hashes of the bundled cat/dog videos
    with open(os.path.join(REPO, "tests", "oracles", "reference_vids_hashes.json")) as f:
        oracle = [vdf.VideoHash.from_json(v) for v in json.load(f).values()]
    want = {frozenset(f"cat.{k}" for k in (1, 2, 3)), frozenset(f"dog.{k}" for k in (1, 2, 3))}
    got = {frozenset(p.rsplit(".", 1)[0] for p in g)
           for g in groups_as_sets(vdf.search(oracle, backend="device", device=dev))}
    require(got == want, f"frozen real-content hashes grouped as {got}")
    decodable = bool({"opencv", "ffmpeg"} & set(available_backends()))
    if decodable:
        vids = sorted(
            os.path.join(REPO, "tests", "data", v)
            for v in os.listdir(os.path.join(REPO, "tests", "data")) if v.endswith(".mp4")
        )
        hashed = hash_videos(vids, device=dev)
        errors = {p: r for p, r in hashed.items() if not isinstance(r, vdf.VideoHash)}
        require(not errors, f"decode errors: {errors}")
        vgroups = groups_as_sets(vdf.search(list(hashed.values()), device=dev))
        require(sorted(len(g) for g in vgroups) == [3, 3]
                and all(len({p[:3] for p in g}) == 1 for g in vgroups),
                f"tests/data videos grouped as {vgroups}")
        phase("real_content", oracle_groups=len(got), videos=len(vids),
              video_groups=len(vgroups))
    else:
        phase("real_content", oracle_groups=len(got),
              videos="decoding unavailable on this host (no opencv/ffmpeg)")

    csrc = "vid_dup_finder_lib_tpu_torch/csrc/"
    kernels = [
        dict(name="hash_dct_kernel", route="cuda", source=csrc + "hash_dct.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hash_pallas.py:58",
             launches=launches["hash_cubes"], max_abs_err=int(diff.max()),
             ms=k1_ms, plain_ms=k1_plain_ms),
        dict(name="band_counts_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:559",
             launches=launches["band_counts"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms),
        dict(name="band_pack_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:130",
             launches=launches["band_pack"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
