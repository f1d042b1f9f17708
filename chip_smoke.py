"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda``, each through its public entry point
with the kernel launch counts set to 0 just before it and read just after:

* the main path, batch hash -> banded search (two-phase sweep, K1-K3) ->
  groups, at a 1,000,000-hash library;
* ``band_1m``: ``search(..., backend="band")`` (the whole-band sweep, K4)
  on the same library;
* ``refs_10k_x_1m``: ``search_with_references`` of 10,000 references
  against 1,000,000 candidates (K2/K3 in their per-row window mode).

It builds every CUDA kernel from ``vid_dup_finder_lib_tpu_torch/csrc`` and
holds each kernel to its plain PyTorch version on the same inputs.  Any
mismatch raises and the script exits non-zero.  It refuses to run without
CUDA.

Output: one progress line per phase; then a JSON line with each kernel's
launch count in its path's run, its largest disagreement with the plain
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
N_REFS = 10_000  # references of the refs phase (tools/bench_refs.py's recipe)
REFS_PLANT_EVERY = 100
PEAK_BYTES_LIMIT = 2 * 2**30  # the band path's device memory at 1M
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


def timed(fn):
    """(fn(), device ms of that one call by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def bit_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest number of differing bits in one int32 word of a and b."""
    return int(np.bitwise_count((a ^ b).cpu().numpy().view(np.uint32)).max(initial=0))


def check_band_sweep(hb, state, tol: int) -> tuple[int, float, float]:
    """K4 against its plain version on every row tile, range by range:
    counts equal everywhere, words equal on every tile with a match.
    Returns the largest bit difference, and the kernel's and the plain
    version's ms summed over the ranges."""
    err, k_ms, p_ms = 0, 0.0, 0.0
    for rt0, rt1 in hb.band_ranges(state):
        (ck, wk), ms = timed(lambda: hb.band_sweep(state, tol, rt0, rt1))
        (cp, wp), pms = timed(lambda: hb.band_sweep_plain(state, tol, rt0, rt1))
        k_ms, p_ms = k_ms + ms, p_ms + pms
        cdiff = int((ck - cp).abs().max()) if cp.numel() else 0
        require(cdiff == 0, f"K4 counts of row tiles [{rt0}, {rt1}) differ by {cdiff}")
        r, s = torch.nonzero(cp, as_tuple=True)
        idx = hb.tile_offsets(state, rt0, rt1)[r] + s
        err = max(err, bit_diff(wk[idx], wp[idx]))
        require(err == 0, f"K4 words of row tiles [{rt0}, {rt1}) differ by {err} bits")
    return err, k_ms, p_ms


def refs_inputs(seed: int):
    """tools/bench_refs.py's headline recipe: 10,000 refs against 1,000,000
    candidates, durations 30-7200 s, every 100th ref a copy of the
    candidate at its window's lo (the planted pairs)."""
    rng = np.random.default_rng(seed)
    cand_durs = np.sort(rng.integers(30, 7200, N_LIBRARY))
    ref_durs = np.sort(rng.integers(30, 7200, N_REFS))
    lo = np.searchsorted(cand_durs, (ref_durs * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(cand_durs, (ref_durs * 1.05).astype(np.int64), "right")
    refs = rng.integers(0, 2**32, (N_REFS, 32), dtype=np.uint64).astype(np.uint32)
    cands = rng.integers(0, 2**32, (N_LIBRARY, 32), dtype=np.uint64).astype(np.uint32)
    planted = [(k, int(lo[k])) for k in range(0, N_REFS, REFS_PLANT_EVERY) if hi[k] > lo[k]]
    for k, c in planted:
        refs[k] = cands[c]
    return refs, ref_durs, cands, cand_durs, lo, hi, planted


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
    from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
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
    k3_err = bit_diff(wk3, wp3)
    require(k3_err == 0, f"packed words differ by up to {k3_err} bits")
    k2_ms = cuda_ms(lambda: hc.band_counts(state, TOL_INT))
    k2_plain_ms = cuda_ms(lambda: hc.band_counts_plain(state, TOL_INT), reps=3)
    k3_ms = cuda_ms(lambda: hc.band_pack(state, hits, TOL_INT))
    k3_plain_ms = cuda_ms(lambda: hc.band_pack_plain(state, hits, TOL_INT))
    t0 = time.perf_counter()
    pairs_i, pairs_j = hc.banded_adjacency_cuda(state, TOL_INT)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pi, pj = hc.banded_adjacency_plain(state, TOL_INT)
    sweep_plain_s = time.perf_counter() - t0
    require(np.array_equal(pairs_i, pi) and np.array_equal(pairs_j, pj),
            f"1M pairs: kernel {len(pairs_i)} vs plain {len(pi)}")
    phase("search_1m", bound="exact", comparisons=comps, pairs=len(pairs_i), hit_tiles=hits.shape[0],
          sweep_s=round(sweep_s, 4), sweep_plain_s=round(sweep_plain_s, 4),
          comps_per_s=f"{comps / sweep_s:.4g}",
          counts_ms=round(k2_ms, 3), counts_plain_ms=round(k2_plain_ms, 3),
          pack_ms=round(k3_ms, 3), pack_plain_ms=round(k3_plain_ms, 3),
          launches=json.dumps({fn.__name__: fn.launches for fn in counters}))

    # ---- K4: the public search(backend="band") on the 1M library, counted
    band_counters = (hb.band_sweep, hc.band_counts, hc.band_pack)
    for fn in band_counters:
        fn.launches = 0
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    band_groups = vdf.search(hashes, TOLERANCE, backend="band", device=dev)
    torch.cuda.synchronize()
    band_e2e_s = time.perf_counter() - t0
    band_peak = torch.cuda.max_memory_allocated(dev) - base
    band_launches = {fn.__name__: fn.launches for fn in band_counters}
    require(band_launches["band_sweep"] > 0, f"K4 launched: {band_launches}")
    require(groups_as_sets(band_groups) == planted,
            f"band search found {len(groups_as_sets(band_groups))} groups")
    require(band_groups == groups, "band and device backends: groups differ")
    require(band_peak < PEAK_BYTES_LIMIT, f"band path peak {band_peak} bytes")
    # the sweep alone on the resident state: pairs, then K4 vs its plain version
    t0 = time.perf_counter()
    bi, bj = hb.banded_adjacency_band(None, None, TOL_INT, state=state)
    band_sweep_s = time.perf_counter() - t0
    require(np.array_equal(bi, pairs_i) and np.array_equal(bj, pairs_j),
            f"1M pairs: K4 {len(bi)} vs two-phase {len(pairs_i)}")
    ranges = hb.band_ranges(state)
    k4_err, k4_sum_ms, k4_plain_ms = check_band_sweep(hb, state, TOL_INT)
    k4_ms = cuda_ms(lambda: [hb.band_sweep(state, TOL_INT, a, b) for a, b in ranges], reps=3)
    phase("band_1m", bound="exact", seconds=round(band_e2e_s, 3), groups=len(band_groups),
          pairs=len(bi), ranges=len(ranges), sweep_s=round(band_sweep_s, 4),
          comps_per_s=f"{comps / band_sweep_s:.4g}", kernel_ms=round(k4_ms, 3),
          kernel_ms_checked=round(k4_sum_ms, 3), plain_ms=round(k4_plain_ms, 3),
          peak_bytes=band_peak, launches=json.dumps(band_launches))

    # ---- dense phase B and nonzero pad bits
    for name, (lib, lb) in (("dense", dense_library(rng)),
                            ("pad_bits", pad_bit_library(rng))):
        st = hc.SearchState(lib, lb, dev)
        ki, kj = hc.banded_adjacency_cuda(st, TOL_INT)
        pi, pj = hc.banded_adjacency_plain(st, TOL_INT)
        require(np.array_equal(ki, pi) and np.array_equal(kj, pj),
                f"{name}: kernel {len(ki)} pairs vs plain {len(pi)}")
        bi, bj = hb.banded_adjacency_band(None, None, TOL_INT, state=st)
        require(np.array_equal(bi, pi) and np.array_equal(bj, pj),
                f"{name}: K4 {len(bi)} pairs vs plain {len(pi)}")
        k4_err = max(k4_err, check_band_sweep(hb, st, TOL_INT)[0])
        if name == "pad_bits":
            hi, hj = banded_adjacency(lib, lb, TOL_INT, backend="host")
            require(np.array_equal(ki, hi) and np.array_equal(kj, hj),
                    f"{name}: kernel {len(ki)} pairs vs host {len(hi)}")
        require(len(ki) > 0, f"{name}: no pairs")
        phase(name, hashes=lib.shape[0], pairs=len(ki), hit_tiles=int(
            (hc.band_counts(st, TOL_INT) > 0).sum()))

    # ---- references search: 10k refs x 1M candidates, public API, counted
    refs, ref_durs, cands, cand_durs, lo, hi, plants = refs_inputs(SEED)
    cand_hashes = vdf.VideoHash.many_from_packed_u32(
        cands, (f"/v/{i:08}.mp4" for i in range(N_LIBRARY)), cand_durs)
    ref_hashes = vdf.VideoHash.many_from_packed_u32(
        refs, (f"/r/{k:06}.mp4" for k in range(N_REFS)), ref_durs)
    refs_comps = int(np.sum(hi - lo))
    for fn in band_counters:
        fn.launches = 0
    t0 = time.perf_counter()
    ref_groups = vdf.search_with_references(ref_hashes, cand_hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    refs_e2e_s = time.perf_counter() - t0
    refs_launches = {fn.__name__: fn.launches for fn in band_counters}
    require(refs_launches["band_counts"] > 0 and refs_launches["band_pack"] > 0,
            f"window-mode kernels launched: {refs_launches}")
    want = {f"/r/{k:06}.mp4": {f"/v/{c:08}.mp4"} for k, c in plants}
    got = {g.reference: set(g.duplicates) for g in ref_groups}
    require(len(plants) == N_REFS // REFS_PLANT_EVERY and got == want,
            f"refs search: {len(got)} groups, {sum(got.get(k) == v for k, v in want.items())}"
            f" of the {len(want)} planted pairs")
    # K2/K3 in window mode vs their plain versions, and the pairs
    rst = hc.RefsState(refs, cands, lo, hi, dev)
    require(rst.comparisons() == refs_comps, "refs state comparisons")
    rk2 = hc.band_counts(rst, TOL_INT)
    rp2 = hc.band_counts_plain(rst, TOL_INT)
    k2_refs_err = int((rk2 - rp2).abs().max())
    require(k2_refs_err == 0, f"window-mode counts differ by up to {k2_refs_err}")
    rhits = hc.hit_tiles(rst, rp2)
    k3_refs_err = bit_diff(hc.band_pack(rst, rhits, TOL_INT), hc.band_pack_plain(rst, rhits, TOL_INT))
    require(k3_refs_err == 0, f"window-mode words differ by up to {k3_refs_err} bits")
    t0 = time.perf_counter()
    ri, rj = hc.refs_adjacency_cuda(rst, TOL_INT)
    refs_sweep_s = time.perf_counter() - t0
    rpi, rpj = hc.refs_adjacency_plain(rst, TOL_INT)
    require(np.array_equal(ri, rpi) and np.array_equal(rj, rpj),
            f"refs pairs: kernel {len(ri)} vs plain {len(rpi)}")
    require(list(zip(ri.tolist(), rj.tolist())) == plants, "refs pairs are the planted ones")
    k2_refs_ms = cuda_ms(lambda: hc.band_counts(rst, TOL_INT))
    k2_refs_plain_ms = cuda_ms(lambda: hc.band_counts_plain(rst, TOL_INT), reps=3)
    k3_refs_ms = cuda_ms(lambda: hc.band_pack(rst, rhits, TOL_INT))
    k3_refs_plain_ms = cuda_ms(lambda: hc.band_pack_plain(rst, rhits, TOL_INT))
    phase("refs_10k_x_1m", bound="exact", refs=N_REFS, candidates=N_LIBRARY,
          comparisons=refs_comps, groups=len(ref_groups), planted_found=len(got),
          seconds=round(refs_e2e_s, 3), sweep_s=round(refs_sweep_s, 4),
          comps_per_s=f"{refs_comps / refs_sweep_s:.4g}", ref_tiles=rst.n_row_tiles,
          slots=rst.slots, hit_tiles=rhits.shape[0],
          counts_ms=round(k2_refs_ms, 3), counts_plain_ms=round(k2_refs_plain_ms, 3),
          pack_ms=round(k3_refs_ms, 3), pack_plain_ms=round(k3_refs_plain_ms, 3),
          launches=json.dumps(refs_launches))

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
             ms=k2_ms, plain_ms=k2_plain_ms,
             refs_launches=refs_launches["band_counts"], refs_max_abs_err=k2_refs_err,
             refs_ms=k2_refs_ms, refs_plain_ms=k2_refs_plain_ms),
        dict(name="band_pack_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:130",
             launches=launches["band_pack"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms,
             refs_launches=refs_launches["band_pack"], refs_max_abs_err=k3_refs_err,
             refs_ms=k3_refs_ms, refs_plain_ms=k3_refs_plain_ms),
        dict(name="band_sweep_kernel", route="cuda", source=csrc + "band_sweep.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_band.py:50",
             launches=band_launches["band_sweep"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
