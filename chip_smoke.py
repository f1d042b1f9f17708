"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on ``cuda``, each through its public entry point
with the kernel launch counts set to 0 just before it and read just after:

* the main path, batch hash -> banded search (two-phase sweep, K1-K3) ->
  groups, at a 1,000,000-hash library;
* ``band_1m``: ``search(..., backend="band")`` (the whole-band sweep, K4)
  on the same library;
* ``refs_10k_x_1m``: ``search_with_references`` of 10,000 references
  against 1,000,000 candidates (K2/K3 in their per-row window mode);
* ``library_1m``: the same searches over a growing device-resident library
  (``IncrementalDeviceLibrary``, ``search(..., device_library=)``): (a) the
  1M library appended in 8 shuffled chunks, (b) appended sorted (zero-copy
  state) on K2 + K3 and on K4, (c) grown by 100,000 rows and searched at
  1.1M, (d) the 10k x 1M references search over a resident library;
* ``device_preproc_1080p``: letterbox detection, resize and hash of 64
  synthetic 1920x1080 videos on the card (``hash_raw_frames_device``),
  flushed at the pipeline's 512 MiB;
* ``real_content``: the bundled clips, hashed with host and with device
  preprocessing;
* ``cli``: the port's CLI (``app.run_app``) on the bundled clips, twice,
  the second time from its cache.

It builds every CUDA kernel from ``vid_dup_finder_lib_tpu_torch/csrc`` and
holds each kernel to its plain PyTorch version on the same inputs.  Any
mismatch raises and the script exits non-zero.  It refuses to run without
CUDA.

Output: one progress line per phase; then a JSON line with each kernel's
launch count in its path's run (and in each later phase that launches it,
``new_phase_launches``), its largest disagreement with the plain
version, its time, the plain version's and, where one PyTorch call
computes the same function, that call's (``library_ms``), and its bound:
the least time the card could take for the same work (``bound_ms``), the
larger of the bytes it must move over the memory rate and its operations
over the peak rate of their type (``bound_by``), from this run's inputs
and the published H100 SXM peaks below, and the kernel's share of it
(``bound_share``); then the card's name and power
limit from nvidia-smi; last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
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
LIBRARY_CHUNKS = 8  # appends of the 1M library
N_GROWTH = 100_000  # rows appended to the sorted library in library_1m (c)
N_GROWTH_CLUSTERS = 20
N_VIDEOS = 64  # synthetic 1080p videos of device_preproc_1080p
VIDEO_SHAPE = (16, 1080, 1920)
N_GOLDEN_VIDEOS = 4  # videos held to the golden cubes bit for bit
HOST_WORKERS = 6  # processes running the host letterbox check
# synthetic bars (top, bottom, left, right, grey level): letterbox,
# pillarbox, windowbox, asymmetric and none, so the videos fall into
# several crop buckets
BARS = [
    (0, 0, 0, 0, 0), (140, 140, 0, 0, 0), (0, 0, 240, 240, 0),
    (60, 60, 200, 200, 16), (132, 132, 0, 0, 8), (20, 0, 0, 0, 240),
    (0, 0, 90, 30, 4), (6, 10, 12, 2, 0),
]
REPO = os.path.dirname(os.path.abspath(__file__))
# published H100 SXM peaks (NVIDIA's data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12
# K1's separable DCT per cube: 16-point passes along y (16 t x 16 x), then x
# (16 t x 10 k), then t (10 j x 10 k), 10 kept outputs each
DCT_PASSES = 16 * 16 + 16 * 10 + 10 * 10  # 516
# least fp32 work of one pass: DCT-II row k is even or odd about the middle,
# so 8 sums and 8 differences (16 FADD), then 8 FMAs per kept output (80)
PASS_FP32_INSTRUCTIONS = 16 + 10 * 8  # 96, 49,536 per cube
PASS_MACS = 10 * 16  # the kernel's design: 160 FMAs per pass, 82,560 per cube


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


def bound(n_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate, and which of the two it is."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sweep_inputs(state) -> int:
    """Bytes of a sweep state's inputs, each read once: the packed rows
    and columns (one matrix in a self-search) and the per-row windows and
    band metadata."""
    cols = None if state.cols is state.rows else state.cols
    return nbytes(state.rows, cols, state.bounds, state.row_lo, state.first_ct_dev,
                  state.n_ct_dev)


def k2_bound(state) -> tuple[float, str]:
    """K2's work: one 1024-deep +/-1 dot product (2 * 1024 int8
    operations on the tensor cores) per in-band pair of this state, and
    one int32 count per (row tile, slot)."""
    return bound(sweep_inputs(state) + state.n_row_tiles * state.slots * 4,
                 2 * 1024 * state.comparisons(), INT8_OPS_PER_S)


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


def planted_library(n: int, seed: int, n_clusters: int = N_CLUSTERS):
    """Random duration-sorted library with planted 3-hash clusters, pad
    bits masked (the recipe of bench.py's synth_library)."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(30, 7200, n))
    starts = rng.choice(n // 8 - 1, n_clusters, replace=False) * 8
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


def make_video(i: int) -> np.ndarray:
    """Synthetic raw video ``i``: uint8[16, 1080, 1920] noise with the bars
    ``BARS[i % len(BARS)]`` (grey level plus up to 7 of noise, inside the
    detector's tolerance), from the seed."""
    rng = np.random.default_rng((SEED, i))
    v = rng.integers(0, 256, VIDEO_SHAPE, dtype=np.uint8)
    top, bottom, left, right, grey = BARS[i % len(BARS)]
    h, w = VIDEO_SHAPE[1:]
    for region in (np.s_[:, :top], np.s_[:, h - bottom :], np.s_[:, :, :left],
                   np.s_[:, :, w - right :]):
        bar = v[region]
        bar[...] = grey + (bar & 7)
    return v


def host_crop(i: int):
    """The host detector's crop of ``make_video(i)`` (run in a worker)."""
    from vid_dup_finder_lib_tpu_torch.ops.letterbox import cropdetect_letterbox

    return cropdetect_letterbox(list(make_video(i)))


def preproc_batches(limit_bytes: int) -> list[list[int]]:
    """The videos in the pipeline's flush order: a batch closes when its
    raw frames reach ``limit_bytes`` (``_hash_videos_device_preproc``)."""
    per_video = int(np.prod(VIDEO_SHAPE))
    out, cur = [], []
    for i in range(N_VIDEOS):
        cur.append(i)
        if len(cur) * per_video >= limit_bytes:
            out.append(cur)
            cur = []
    return out + ([cur] if cur else [])


def reset(counters) -> None:
    for fn in counters:
        fn.launches = 0


def counts(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def device_preproc_phase(dev, hash_cubes) -> int:
    """``device_preproc_1080p``: the synthetic 1080p videos in the
    pipeline's 512 MiB batches through ``hash_raw_frames_device`` (h2d from
    pinned memory, letterbox, resize, K1), then each stage alone on the
    uploaded batch; crops held to the host detector for every video, cubes
    and hashes to the golden model for the first four.  Returns the hash
    kernel's launches in the public calls."""
    from vid_dup_finder_lib_tpu_torch.models.pipeline import (
        DEFAULT_PREPROC_BATCH_BYTES,
        hash_raw_frames_device,
    )
    from vid_dup_finder_lib_tpu_torch.ops.golden import crop_resize_golden, hash_bits_golden
    from vid_dup_finder_lib_tpu_torch.ops.letterbox_device import cropdetect_letterbox_device
    from vid_dup_finder_lib_tpu_torch.ops.resize_device import resize_frames_device
    from vid_dup_finder_lib_tpu_torch.video_hash import VideoHash

    batches = preproc_batches(DEFAULT_PREPROC_BATCH_BYTES)
    crops, words, golden_candidates = {}, {}, {}
    stage_ms = {"h2d": [], "letterbox": [], "resize": [], "hash": []}
    public_s, launched = 0.0, 0
    for batch in batches:
        host = np.stack([make_video(i) for i in batch])
        torch.cuda.synchronize()
        before = hash_cubes.launches
        t0 = time.perf_counter()
        out = hash_raw_frames_device(host, device=dev)
        torch.cuda.synchronize()
        public_s += time.perf_counter() - t0
        launched += hash_cubes.launches - before
        # the same batch, stage by stage, timed by CUDA events
        pinned = torch.from_numpy(host).pin_memory()
        frames, ms = timed(lambda: pinned.to(dev, non_blocking=True))
        stage_ms["h2d"].append(ms)
        bcrops, ms = timed(lambda: cropdetect_letterbox_device(frames))
        stage_ms["letterbox"].append(ms)

        def resize():
            cubes = torch.empty((len(batch), 16, 16, 16), dtype=torch.uint8, device=dev)
            for crop in set(bcrops):
                idx = torch.tensor([k for k, c in enumerate(bcrops) if c == crop], device=dev)
                cubes[idx] = resize_frames_device(frames.index_select(0, idx), crop)
            return cubes

        cubes, ms = timed(resize)
        stage_ms["resize"].append(ms)
        staged, ms = timed(lambda: hash_cubes(cubes))
        stage_ms["hash"].append(ms)
        require(torch.equal(staged, out), "hash_raw_frames_device differs from its stages")
        for k, i in enumerate(batch):
            crops[i], words[i] = bcrops[k], out[k]
            if i < N_GOLDEN_VIDEOS:
                golden_candidates[i] = cubes[k].cpu().numpy()
        del host, pinned, frames, cubes, out, staged
    require(launched > 0, "device preprocessing launched no hash kernel")

    # the host detector on every video, in worker processes
    with multiprocessing.get_context("spawn").Pool(HOST_WORKERS) as pool:
        host_crops = pool.map(host_crop, range(N_VIDEOS))
    bad = [i for i in range(N_VIDEOS) if crops[i] != host_crops[i]]
    require(not bad, f"device crops differ from the host's for videos {bad}")
    buckets = len(set(host_crops))
    require(buckets >= 5, f"only {buckets} crop buckets")
    worst = 0
    for i in range(N_GOLDEN_VIDEOS):
        # golden frames are transposed views: stack them contiguous for the kernel
        gold = np.ascontiguousarray(
            np.stack([crop_resize_golden(f, host_crops[i]) for f in make_video(i)]))
        require(np.array_equal(golden_candidates[i], gold), f"video {i}: cubes differ from golden")
        require(torch.equal(words[i], hash_cubes(torch.from_numpy(gold[None]).to(dev))[0]),
                f"video {i}: hash differs from hash_cubes of the golden cube")
        bits = VideoHash.from_packed_u32(words[i].cpu().numpy().view(np.uint32)).hash_bits()
        worst = max(worst, int((bits != hash_bits_golden(gold)).sum()))
    require(worst <= 2, f"device preprocessing vs f64 golden hash: {worst} bits")
    phase("device_preproc_1080p", videos=N_VIDEOS, batches=json.dumps([len(b) for b in batches]),
          crop_buckets=buckets, crops="exact", golden_cubes=f"{N_GOLDEN_VIDEOS} bit-exact",
          golden_hash_max_bits=worst, public_s=round(public_s, 4),
          videos_per_s=f"{N_VIDEOS / public_s:.4g}", public_includes="pinning + h2d",
          stage_ms_per_batch=json.dumps({k: [round(x, 3) for x in v] for k, v in stage_ms.items()}),
          stages_include="h2d timed apart; letterbox includes its 16-byte-per-video d2h",
          launches=json.dumps({"hash_cubes": launched}))
    return launched


def cli_phase(dev, hash_cubes) -> dict:
    """``cli``: ``run_app`` in process on the bundled clips with a fresh
    cache and JSON output, twice; the second run must rehash nothing."""
    from vid_dup_finder_lib_tpu_torch.app import app_fns

    data = os.path.join(REPO, "tests", "data")
    rehashed = []
    real_update = app_fns.update_hash_cache

    def counted_update(cfg, cache):
        rehashed.append(real_update(cfg, cache))
        return rehashed[-1]

    runs = []
    app_fns.update_hash_cache = counted_update
    try:
        with tempfile.TemporaryDirectory() as tmp:
            args = ["--files", data, "--cache-file", os.path.join(tmp, "cache.json"),
                    "--cropdetect", "letterbox", "--output-format", "json"]
            for _ in range(2):
                hash_cubes.launches = 0
                out = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = app_fns.run_app(args, device=dev)
                torch.cuda.synchronize()
                runs.append(dict(rc=rc, seconds=round(time.perf_counter() - t0, 4),
                                 groups=json.loads(out.getvalue()), hash_cubes=hash_cubes.launches))
    finally:
        app_fns.update_hash_cache = real_update
    first, second = runs
    names = sorted(sorted(os.path.basename(p)[:3] for p in g["duplicates"]) for g in first["groups"])
    require(first["rc"] == 0 and names == [["cat"] * 3, ["dog"] * 3],
            f"cli: rc {first['rc']}, groups {first['groups']}")
    require(first["hash_cubes"] > 0 and rehashed[0] == 6,
            f"cli: {rehashed[0]} rehashed, {first['hash_cubes']} hash launches")
    require(second["rc"] == 0 and second["groups"] == first["groups"], "cli: second run differs")
    require(rehashed[1] == 0 and second["hash_cubes"] == 0,
            f"cli: the second run rehashed {rehashed[1]} files")
    phase("cli", groups=len(first["groups"]), rehashed=json.dumps(rehashed),
          seconds=json.dumps([r["seconds"] for r in runs]),
          launches=json.dumps({"hash_cubes": first["hash_cubes"]}),
          second_run_launches=json.dumps({"hash_cubes": second["hash_cubes"]}))
    return {"hash_cubes": first["hash_cubes"]}


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
        _d3_on,
        _dct_on,
        full_fp32_matmul,
        hash_cubes,
        hash_cubes_plain,
    )
    from vid_dup_finder_lib_tpu_torch.tools.k1_flat_cubes import flat_cube_report
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
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    groups = vdf.search(hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    search_s = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in counters}
    found = groups_as_sets(groups)
    require(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    require(found == planted, f"1M search found {len(found)} groups, "
            f"{len(found & planted)} of the {len(planted)} planted")
    # the public search again, warm: its wall time as a user sees it
    t0 = time.perf_counter()
    again = vdf.search(hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    search_again_s = time.perf_counter() - t0
    require(again == groups, "a second public search gave other groups")
    phase("main_path", seconds=round(e2e_s, 3), search_s=round(search_s, 4),
          search_again_s=round(search_again_s, 4), groups=len(found),
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
    # flat cubes (every value 0..255): all AC coefficients are exactly 0, so
    # their AC signs are fp32 rounding noise in any order; only bin 0 and the
    # all-zero words of the 128 cube are held, the rest is reported
    flat = flat_cube_report(hash_cubes, hash_cubes_plain, hash_bits_golden, dev)
    require(flat["same_on_two_launches"], "flat cubes: two launches differ")
    require(flat["bin0_exact"] and flat["cube128_zero"], "flat cubes: bin 0 or the 128 cube")
    k1_ms = cuda_ms(lambda: hash_cubes(cubes))
    k1_plain_ms = cuda_ms(lambda: hash_cubes_plain(cubes))
    # yardstick only: K1's product as one fp32 torch.matmul, TF32 off (the
    # sign and the packing are left out); the port never calls it
    centred = (cubes.view(N_CUBES, -1).to(torch.float32) - 128).contiguous()
    operator = _d3_on(dev)
    with full_fp32_matmul():
        k1_library_ms = cuda_ms(lambda: torch.matmul(centred, operator))
    del centred
    # K1's work: the separable DCT with the even/odd split, 49,536 fp32-pipe
    # instructions per cube (an FADD takes an FMA's issue slot, so each counts
    # as the peak rate's 2 FLOP); the kernel's own 82,560 FMAs per cube are
    # kept beside it as design_bound_ms, the collapsed operator's 1024 * 4096
    # as collapsed_bound_ms
    k1_bytes = nbytes(cubes, _dct_on(dev), words)
    k1_bound_ms, k1_bound_by = bound(
        k1_bytes, 2 * N_CUBES * DCT_PASSES * PASS_FP32_INSTRUCTIONS, FP32_FLOPS_PER_S)
    k1_design_bound_ms, _ = bound(
        k1_bytes, 2 * N_CUBES * DCT_PASSES * PASS_MACS, FP32_FLOPS_PER_S)
    k1_collapsed_bound_ms, _ = bound(
        nbytes(cubes, operator, words), 2 * N_CUBES * operator.shape[0] * operator.shape[1],
        FP32_FLOPS_PER_S)
    phase("hash", bound=repr("vs plain <=2 bits/hash, <=1e-4 of bits; vs golden <=2/hash, <=8 total"),
          vs_plain_bits=int(diff.sum()), vs_plain_worst=int(diff.max()),
          vs_golden_bits=sum(gold), vs_golden_worst=max(gold),
          kernel_ms=round(k1_ms, 4), plain_ms=round(k1_plain_ms, 3),
          library_ms=round(k1_library_ms, 3), bound_ms=round(k1_bound_ms, 4),
          bound_by=k1_bound_by, bound_share=round(k1_bound_ms / k1_ms, 4),
          design_bound_ms=round(k1_design_bound_ms, 4),
          collapsed_bound_ms=round(k1_collapsed_bound_ms, 3),
          flat_cubes=flat["flat_cubes"], flat_vs_plain_bits=flat["vs_plain_bits"],
          flat_vs_plain_worst=flat["vs_plain_worst"], flat_vs_golden_bits=flat["vs_golden_bits"],
          flat_vs_golden_worst=flat["vs_golden_worst"],
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
    k2_bound_ms, k2_bound_by = k2_bound(state)
    k3_ms = cuda_ms(lambda: hc.band_pack(state, hits, TOL_INT))
    k3_plain_ms = cuda_ms(lambda: hc.band_pack_plain(state, hits, TOL_INT))
    n_hits = hits.shape[0]
    k3_bound_ms, k3_bound_by = bound(
        n_hits * (2 * hc.TILE * 128 + hc.TILE * 16) + nbytes(hits, state.bounds, state.row_lo),
        2 * 1024 * hc.TILE * hc.TILE * n_hits, INT8_OPS_PER_S)
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
          counts_bound_ms=round(k2_bound_ms, 3), counts_bound_by=k2_bound_by,
          counts_bound_share=round(k2_bound_ms / k2_ms, 4), counts_max_abs_err=k2_err,
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
    # K4's outputs: the counts, and the words of every tile with a match
    k4_bound_ms, k4_bound_by = bound(
        sweep_inputs(state) + state.n_row_tiles * state.slots * 4 + n_hits * hc.TILE * 16,
        2 * 1024 * comps, INT8_OPS_PER_S)
    phase("band_1m", bound="exact", seconds=round(band_e2e_s, 3), groups=len(band_groups),
          pairs=len(bi), ranges=len(ranges), sweep_s=round(band_sweep_s, 4),
          comps_per_s=f"{comps / band_sweep_s:.4g}", kernel_ms=round(k4_ms, 3),
          kernel_ms_checked=round(k4_sum_ms, 3), plain_ms=round(k4_plain_ms, 3),
          bound_ms=round(k4_bound_ms, 3), bound_by=k4_bound_by,
          bound_share=round(k4_bound_ms / k4_ms, 4),
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
    k2_refs_bound_ms, _ = k2_bound(rst)
    k3_refs_ms = cuda_ms(lambda: hc.band_pack(rst, rhits, TOL_INT))
    k3_refs_plain_ms = cuda_ms(lambda: hc.band_pack_plain(rst, rhits, TOL_INT))
    phase("refs_10k_x_1m", bound="exact", refs=N_REFS, candidates=N_LIBRARY,
          comparisons=refs_comps, groups=len(ref_groups), planted_found=len(got),
          seconds=round(refs_e2e_s, 3), sweep_s=round(refs_sweep_s, 4),
          comps_per_s=f"{refs_comps / refs_sweep_s:.4g}", ref_tiles=rst.n_row_tiles,
          slots=rst.slots, hit_tiles=rhits.shape[0],
          counts_ms=round(k2_refs_ms, 3), counts_plain_ms=round(k2_refs_plain_ms, 3),
          counts_bound_ms=round(k2_refs_bound_ms, 4),
          counts_bound_share=round(k2_refs_bound_ms / k2_refs_ms, 4),
          counts_max_abs_err=k2_refs_err, pack_ms=round(k3_refs_ms, 3), pack_plain_ms=round(k3_refs_plain_ms, 3),
          launches=json.dumps(refs_launches))

    # ---- library_1m: the same searches over a growing device-resident library
    two_phase = (hc.band_counts, hc.band_pack)
    lib_launches = {}

    def library_run(name, fn, lib_counters=two_phase):
        """Run ``fn`` counted, with its wall seconds and peak device
        memory above what was allocated before it."""
        reset(band_counters)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counts(band_counters)
        require(all(launched[fn.__name__] > 0 for fn in lib_counters),
                f"library_1m ({name}): kernels launched {launched}")
        lib_launches[name] = launched
        return out, dict(seconds=round(seconds, 4),
                         peak_bytes=torch.cuda.max_memory_allocated(dev) - base,
                         launches=json.dumps(launched))

    def appended(rows, chunks=LIBRARY_CHUNKS):
        lib = hc.IncrementalDeviceLibrary(dev)
        for part in np.array_split(rows, chunks):
            lib.append(part)
        return lib

    # (a) shuffled insertion order, 8 appends, then a gather into sorted order
    perm = np.random.default_rng(SEED).permutation(N_LIBRARY)
    t0 = time.perf_counter()
    lib = appended(packed[perm])
    torch.cuda.synchronize()
    append_s = time.perf_counter() - t0
    lib_paths = [paths[k] for k in perm]
    a_groups, a = library_run("a", lambda: vdf.search(
        hashes, TOLERANCE, device_library=lib, library_paths=lib_paths, device=dev))
    require(groups_as_sets(a_groups) == planted and a_groups == groups,
            f"library (a): {len(groups_as_sets(a_groups) & planted)} of {len(planted)}"
            " planted groups, or groups unequal to the upload path's")
    phase("library_1m_a", insertion="shuffled", appends=LIBRARY_CHUNKS,
          append_s=round(append_s, 4), capacity=lib.capacity, groups=len(a_groups),
          planted_found=len(groups_as_sets(a_groups) & planted), **a)
    del lib, lib_paths

    # (b) sorted insertion order: the state shares the library's buffer
    lib = appended(packed)
    states = []
    real_state = lib.state
    lib.state = lambda order, bounds: states.append(real_state(order, bounds)) or states[-1]
    b_groups, b = library_run("b", lambda: vdf.search(
        hashes, TOLERANCE, device_library=lib, device=dev))
    zero_copy = states[-1].packed.data_ptr() == lib.packed.data_ptr()
    require(zero_copy, "library (b): the identity-order state copied the buffer")
    require(b_groups == groups, "library (b): groups unequal to the upload path's")
    bb_groups, bb = library_run("b_band", lambda: vdf.search(
        hashes, TOLERANCE, backend="band", device_library=lib, device=dev),
        lib_counters=(hb.band_sweep,))
    require(states[-1].packed.data_ptr() == lib.packed.data_ptr(),
            "library (b, band): the identity-order state copied the buffer")
    require(bb_groups == groups, "library (b, band): groups unequal to the upload path's")
    phase("library_1m_b", insertion="sorted", zero_copy=zero_copy, groups=len(b_groups),
          band_groups=len(bb_groups), band_seconds=bb["seconds"],
          band_peak_bytes=bb["peak_bytes"], band_launches=bb["launches"], **b)

    # (c) 100,000 new rows with 20 more planted clusters, durations spread
    # among the old ones: the library grows past its capacity and the
    # search gathers 1.1M rows into sorted order
    g_packed, g_durs, g_starts = planted_library(N_GROWTH, SEED + 1, N_GROWTH_CLUSTERS)
    g_paths = [f"g{i:06d}" for i in range(N_GROWTH)]
    cap_before = lib.capacity
    lib.append(g_packed)
    grown = vdf.VideoHash.many_from_packed_u32(
        np.concatenate([packed, g_packed]), paths + g_paths,
        np.concatenate([durations, g_durs]))
    all_planted = planted | {frozenset(g_paths[s + k] for k in range(CLUSTER_SIZE))
                             for s in g_starts}
    c_groups, c = library_run("c", lambda: vdf.search(
        grown, TOLERANCE, device_library=lib, library_paths=paths + g_paths, device=dev))
    c_found = groups_as_sets(c_groups)
    require(c_found == all_planted,
            f"library (c): {len(c_found & all_planted)} of {len(all_planted)} planted groups"
            f" ({len(c_found)} found)")
    phase("library_1m_c", rows=lib.n, capacity_before=cap_before, capacity=lib.capacity,
          groups=len(c_groups), planted_found=len(c_found & all_planted), **c)
    del lib, states, real_state, grown

    # (d) the 10k x 1M references search over a resident candidate library
    lib = appended(cands)
    d_groups, d = library_run("d", lambda: vdf.search_with_references(
        ref_hashes, cand_hashes, TOLERANCE, device_library=lib, device=dev))
    d_got = {g.reference: set(g.duplicates) for g in d_groups}
    require(d_got == want and d_groups == ref_groups,
            f"library (d): {sum(d_got.get(k) == v for k, v in want.items())} of the"
            f" {len(want)} planted pairs, or groups unequal to the upload path's")
    phase("library_1m_d", refs=N_REFS, candidates=N_LIBRARY, planted_found=len(d_got),
          upload_seconds=round(refs_e2e_s, 4), **d)
    del lib

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
        # the same clips with letterbox detection and resize on the card
        hash_cubes.launches = 0
        dhashed = hash_videos(vids, device=dev, device_preproc=True)
        preproc_real_launches = hash_cubes.launches
        require(preproc_real_launches > 0, "device preprocessing launched no hash kernel")
        require(all(isinstance(h, vdf.VideoHash) for h in dhashed.values()),
                f"device preprocessing: {dhashed}")
        drift = max(dhashed[v].hamming_distance(hashed[v]) for v in vids)
        require(drift <= 2, f"device vs host preprocessing: {drift} bits in one hash")
        dgroups = groups_as_sets(vdf.search(list(dhashed.values()), device=dev))
        require(dgroups == vgroups, f"device preprocessing grouped as {dgroups}")
        phase("real_content", oracle_groups=len(got), videos=len(vids),
              video_groups=len(vgroups), device_preproc_groups=len(dgroups),
              device_preproc_max_bits=drift,
              device_preproc_launches=json.dumps({"hash_cubes": preproc_real_launches}))
        cli = cli_phase(dev, hash_cubes)
    else:
        phase("real_content", oracle_groups=len(got),
              videos="decoding unavailable on this host (no opencv/ffmpeg)")
        cli = {"hash_cubes": 0}
        phase("cli", skipped="decoding unavailable on this host (no opencv/ffmpeg)")

    preproc_launches = device_preproc_phase(dev, hash_cubes)

    csrc = "vid_dup_finder_lib_tpu_torch/csrc/"
    kernels = [
        dict(name="hash_dct_kernel", route="cuda", source=csrc + "hash_dct.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hash_pallas.py:58",
             launches=launches["hash_cubes"], max_abs_err=int(diff.max()),
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound_ms, bound_by=k1_bound_by,
             library_ms=k1_library_ms, bound_share=k1_bound_ms / k1_ms,
             design_bound_ms=k1_design_bound_ms, collapsed_bound_ms=k1_collapsed_bound_ms,
             new_phase_launches={"device_preproc_1080p": preproc_launches,
                                 "cli": cli["hash_cubes"]}),
        dict(name="band_counts_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:559",
             launches=launches["band_counts"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_bound_by,
             library_ms=None, bound_share=k2_bound_ms / k2_ms,
             refs_launches=refs_launches["band_counts"], refs_max_abs_err=k2_refs_err,
             refs_ms=k2_refs_ms, refs_plain_ms=k2_refs_plain_ms, refs_bound_ms=k2_refs_bound_ms,
             new_phase_launches={f"library_1m_{k}": v["band_counts"] for k, v in lib_launches.items()}),
        dict(name="band_pack_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:130",
             launches=launches["band_pack"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound_ms, bound_by=k3_bound_by,
             library_ms=None,
             refs_launches=refs_launches["band_pack"], refs_max_abs_err=k3_refs_err,
             refs_ms=k3_refs_ms, refs_plain_ms=k3_refs_plain_ms,
             new_phase_launches={f"library_1m_{k}": v["band_pack"] for k, v in lib_launches.items()}),
        dict(name="band_sweep_kernel", route="cuda", source=csrc + "band_sweep.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_band.py:50",
             launches=band_launches["band_sweep"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=k4_bound_ms, bound_by=k4_bound_by,
             library_ms=None, bound_share=k4_bound_ms / k4_ms,
             new_phase_launches={f"library_1m_{k}": v["band_sweep"] for k, v in lib_launches.items()}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
