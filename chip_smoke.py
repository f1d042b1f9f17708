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
* ``scale_8m``: a library of 8,000,000 hashes resident on the card, swept by
  the two-phase sweep in slabs of row tiles (K2 + K3 under the counts
  budget) and, as the independent check, by K4; then the public ``search``
  and ``search_with_references`` (10,000 references) over it;
* the multi-device layer (``parallel/``) on shards of the card, which run
  in turn with the same planning, per-shard launches, copies between shards
  and merge as shards on cards of their own: ``ring_1m`` (the 1M library
  through ``banded_adjacency_ring`` on 4 and on 16 shards, and
  ``search(backend="ring")``), ``refs_sharded_10k_x_1m`` (the references
  split over 4 shards, and ``search_with_references`` with
  ``VDF_REFS_SHARDED=1``), ``sharded_hash`` (the 65,536 cubes over 4
  shards) and ``ring_scan`` (``ring_candidate_scan`` of 16,384 hashes on 4
  shards); ``scale_8m`` also runs its resident library through the ring on
  4 shards (``ring_8m``).  Each ring phase prints its blocks' cuts (at
  equal in-band pairs), each (shard, step)'s seconds and pairs, and the
  wall they project for shards on distinct cards;
* with two cards or more, the same over every card (at most 4), each
  exact against the one-card sweep: ``ring_1m_distinct_cards``,
  ``ring_8m_distinct_cards``, ``refs_sharded_10k_x_1m_distinct_cards``
  (with the public references search, which stays on one card)
  and ``auto_ring_1m`` (``search()`` as a user calls it, which must take
  the ring exactly where the rule says so); on one card each prints a skip
  line.  The other phases keep to one card (``VDF_AUTO_RING=0``,
  ``VDF_REFS_SHARDED=0``);
* ``native_cpu``: on the card's host, with ``device="cpu"``, the native host
  runtime (``native.py``, built by g++) against the card's results;
* ``device_preproc_1080p``: letterbox detection, resize and hash of 64
  synthetic 1920x1080 videos on the card (``hash_raw_frames_device``),
  flushed at the pipeline's 512 MiB;
* ``real_content``: the bundled clips, hashed with host and with device
  preprocessing;
* ``cli``: the port's CLI (``app.run_app``) on the bundled clips, twice,
  the second time from its cache.

It builds every CUDA kernel from ``vid_dup_finder_lib_tpu_torch/csrc`` and
holds each kernel to its plain PyTorch version on the same inputs.  K3 is
also timed where phase B is not small: on the hit list of a library with
many duplicates (``dense``) and on a list of every band tile of a run of
row tiles of the 1M library (``pack_full``, at least 65,536 tiles), so
that its time per tile can be read beside K2's.  One K3 launch on a short
hit list is shorter than its wrapper's host work, so K3's ``ms`` is taken
with the launches queued behind a long kernel (``queued_ms``); the time of
one call between two events is kept as ``call_ms``.  Any mismatch raises
and the script exits non-zero.  It refuses to run without CUDA.

The public calls' host work is broken down on their phase lines: the warm
1M ``search()`` (``main_path``), the shuffled and the sorted resident
library (``library_1m_a`` / ``_b``) and the 8M one (``scale_8m_c``) by the
search's steps (``steps_s``: the Search, the attach, the bounds, the sweep
state and its h2d, the sweep, the decode and d2h, the CSR, the greedy
replay, the MatchGroups), the 10k references (``refs_10k_x_1m``,
``scale_8m_d``) by theirs (the windows, the reference matrix, the state's
h2d, the sweep, the result loop), each step called on its own with the
card synchronised around it (:func:`search_steps`, :func:`refs_steps`);
the 8M objects apart from their path strings; the first search's
adjacency apart from the rest of it; and the cyclic GC's seconds inside
each (``*gc_s``, :class:`GcClock`), also in ``sharded_hash`` and
``device_preproc_1080p`` (with each batch's upload alone, ``upload_s``).

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
import gc
import importlib
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
N_SCALE = 8_000_000  # hashes of scale_8m (the 1M recipe, not cut)
SEAM_BUDGETS = (1 << 20, 1 << 17)  # forced counts budgets at 1M: 6 and 43 slabs
SAMPLE_ROW_TILES = 4  # row tiles of each slab held to the plain versions at 8M
SAMPLE_TOL_LOOSE = 470  # ... also at a tolerance most of their tiles hold matches at
N_NATIVE = 100_000  # rows of the 1M library searched by native_cpu
N_NATIVE_REFS = 1_000  # references of native_cpu's windowed sweep
FULL_LIST_TILES = 65_536  # least length of pack_full's hit list
FULL_LIST_SAMPLE = 31  # 1 tile in 31 of it is held to the plain version
RING_SHARDS = (4, 16)  # shards of the card in ring_1m: bands cross 1 and 2 blocks
N_SCAN = 16_384  # hashes of ring_scan
SCAN_TOL = 470  # ... at a tolerance where most rows have candidates
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


@contextlib.contextmanager
def environ(**kv):
    """Environment variables set to a value, or unset for None, inside the
    block; each restored after it."""
    saved = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_name(prefix: str, run: str) -> str:
    """The phase line a run's launches were counted on."""
    return run if run.startswith("auto_") else f"{prefix}_{run}"


def cards_mesh():
    """Every visible card, at most 4, one shard each; None on one card."""
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    cards = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i) for i in range(min(4, cards))]) if cards >= 2 else None


def ring_fields(ph: dict) -> dict:
    """Phase-line fields of ``ring_cuda.LAST_RING_PHASES``: the block
    starts, each (shard, step)'s seconds and in-band pairs, the walls
    projected from them for shards on distinct cards (a barrier after each
    step, and none), and the rest of the breakdown."""
    keys = ("cuts", "shard_s", "shard_pairs", "projected_wall_s", "projected_free_s")
    return dict(
        cuts=json.dumps(ph["cuts"]),
        shard_s=json.dumps([[round(t, 4) for t in per_step] for per_step in ph["shard_s"]]),
        shard_pairs=json.dumps(ph["shard_pairs"]),
        projected_wall_s=round(ph["projected_wall_s"], 4),
        projected_free_s=round(ph["projected_free_s"], 4),
        phases=json.dumps({k: round(v, 4) if isinstance(v, float) else v
                           for k, v in ph.items() if k not in keys}))


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


def queued_ms(fn, busy, launches: int = 20) -> float:
    """Device ms of one ``fn()`` whose launch the host does not hold up:
    ``busy()`` first occupies the card, so that the ``launches`` calls are
    all enqueued before the first can start, and the time from the end of
    ``busy`` to the end of the last is the kernels' own."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy()
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


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


def k3_bound(state, hits) -> tuple[float, str]:
    """K3's work: per hit tile one 1024-deep +/-1 dot product for each of
    its 128 x 128 pairs, its packed row and column tiles read and 2 KB of
    words written; the hit list and the per-row windows read once."""
    tile = 128
    n_hits = hits.shape[0]
    return bound(n_hits * (2 * tile * 128 + tile * 16) + nbytes(hits, state.bounds, state.row_lo),
                 2 * 1024 * tile * tile * n_hits, INT8_OPS_PER_S)


def band_tiles(hc, state, rt0: int, least: int) -> torch.Tensor:
    """int32[H, 2]: every band tile (row tile, column tile) of the row
    tiles from ``rt0`` on, row-major, until at least ``least`` tiles."""
    rt1 = rt0 + int(np.searchsorted(np.cumsum(state.n_ct[rt0:]), least)) + 1
    require(rt1 <= state.n_row_tiles, "the band holds too few tiles for the full hit list")
    in_band = torch.arange(state.slots, device=state.device)[None, :] < state.n_ct_dev[:, None]
    in_band[:rt0] = False
    in_band[rt1:] = False
    return hc.hit_tiles(state, in_band)


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


def planted_pairs(starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The (i, j) pairs inside ``planted_library``'s clusters, lexicographic:
    all a random library of this recipe holds within the tolerance."""
    pairs = sorted((int(s) + a, int(s) + b) for s in starts
                   for a in range(CLUSTER_SIZE) for b in range(a + 1, CLUSTER_SIZE))
    ii, jj = zip(*pairs)
    return np.array(ii, np.int64), np.array(jj, np.int64)


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


class GcClock:
    """Seconds Python's cyclic GC spent collecting since :meth:`start`
    (``gc.callbacks``, as ``tools/torch_first_search.py`` counts them);
    ``last`` holds those inside the latest :func:`measured` call."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self.last = 0.0
        self._t0 = 0.0

    def start(self) -> None:
        gc.callbacks.append(self._callback)

    def _callback(self, when: str, info: dict) -> None:
        if when == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0


GC = GcClock()


def measured(fn, counters, dev):
    """``fn()`` with the launch counts at 0 before it: its result, wall
    seconds (synchronised), peak device memory above what was allocated
    before it, and the launches; the GC seconds inside it in ``GC.last``."""
    reset(counters)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    g0 = GC.seconds
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    GC.last = GC.seconds - g0
    return out, seconds, torch.cuda.max_memory_allocated(dev) - base, counts(counters)


class Steps:
    """The host breakdown of one public call: the call's own steps, called
    one by one from outside, each timed by the host clock with the card
    synchronised before and after it, and the GC seconds inside each."""

    def __init__(self) -> None:
        self.seconds: dict[str, float] = {}
        self.gc: dict[str, float] = {}

    def __call__(self, name: str, fn):
        torch.cuda.synchronize()
        g0 = GC.seconds
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        self.gc[name] = GC.seconds - g0
        return out

    def fields(self, prefix: str = "steps") -> dict:
        """Phase-line fields: the steps' seconds, their sum and their GC."""
        return {f"{prefix}_s": json.dumps({k: round(v, 4) for k, v in self.seconds.items()}),
                f"{prefix}_total_s": round(sum(self.seconds.values()), 4),
                f"{prefix}_gc_s": json.dumps({k: round(v, 4) for k, v in self.gc.items() if v})}


def sweep_words(hc, state, tol: int) -> list:
    """The two-phase sweep without its decode (``hamming_cuda._two_phase``):
    per slab with a band, K2, the hit list and K3; (hits, words) per slab
    with a hit."""
    out = []
    for rt0, rt1 in hc.count_slabs(state):
        if not state.n_ct[rt0:rt1].any():
            continue
        hits = hc.hit_tiles(state, hc.band_counts(state, tol, rt0, rt1), rt0)
        if hits.shape[0]:
            out.append((hits, hc.band_pack(state, hits, tol)))
    return out


def decode_pairs(hc, state, words) -> tuple[np.ndarray, np.ndarray]:
    """The rest of ``_two_phase``: the words decoded on the card, the pairs
    of every slab fetched to the host."""
    pairs = [hc.decode_words(state, h, w) for h, w in words]
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii, jj = (torch.cat(p).cpu().numpy() for p in zip(*pairs))
    return ii, jj


def search_steps(hc, hashes, dev, lib=None, lib_paths=None):
    """The public ``search(hashes, TOLERANCE, device=dev[, device_library=lib,
    library_paths=lib_paths])`` step by step (:class:`Steps`): the Search,
    the attach, the bounds, the sweep state (its h2d, or the resident rows),
    the sweep, the decode and d2h, the CSR, the greedy replay and the
    MatchGroups.  Returns (groups, steps)."""
    sm = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")  # the package's `search` is the function

    st = Steps()
    s = st("construct", lambda: sm.Search(hashes, device=dev))
    if lib is not None:
        st("attach", lambda: s.attach_device_library(lib, lib_paths))
    bounds = st("bounds", s._self_search_bounds)
    state = st("state_h2d", lambda: hc.SearchState(s._packed_matrix(), bounds, s.device) if lib is None
               else lib.state(s._library_order, bounds))
    words = st("sweep", lambda: sweep_words(hc, state, TOL_INT))
    ii, jj = st("decode_d2h", lambda: decode_pairs(hc, state, words))
    del state, words
    off = st("csr", lambda: s._adjacency_offsets(ii, len(s.entries)) if hasattr(s, "_adjacency_offsets")
             else np.searchsorted(ii, np.arange(len(s.entries) + 1)))  # a tree before the bincount
    s._adj_j, s._adj_off, s._tol_of_adjacency = jj, off, TOL_INT
    matches = st("replay", lambda: s.search_self(TOLERANCE))
    return st("groups", lambda: sm._groups(matches)), st


def reference_windows(s, refs):
    """(order, lo, hi): the references' duration order and the sorted
    references' candidate windows, as the tree's batched references search
    computes them (a tree without ``Search._reference_windows`` calls
    ``_duration_slice`` once per reference)."""
    if hasattr(s, "_reference_windows"):
        return s._reference_windows(refs)
    order = sorted(range(len(refs)), key=lambda k: refs[k].duration)
    windows = np.array([s._duration_slice(refs[k].duration) for k in order], np.int64)
    return order, windows[:, 0], windows[:, 1]


def reference_matrix(s, refs, order):
    """The sorted references' packed rows, as the tree builds them."""
    if hasattr(s, "_reference_matrix"):
        return s._reference_matrix(refs, order)
    from vid_dup_finder_lib_tpu_torch.video_hash import hashes_to_matrix

    return hashes_to_matrix([refs[k] for k in order])


def refs_steps(hc, ref_hashes, cand_hashes, dev, lib=None):
    """The public ``search_with_references(ref_hashes, cand_hashes,
    TOLERANCE, device=dev[, device_library=lib])`` step by step
    (:class:`Steps`): the Search (and the attach), the windows, the
    reference matrix, the sweep state (the h2d of both matrices, or of the
    references beside the resident rows), the sweep, the decode and d2h,
    the result loop and the MatchGroups.  Returns (groups, steps)."""
    sm = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")  # the package's `search` is the function
    from vid_dup_finder_lib_tpu_torch.match_group import MatchGroup

    st = Steps()
    s = st("construct", lambda: sm.Search(cand_hashes, device=dev))
    if lib is not None:
        st("attach", lambda: s.attach_device_library(lib, None))
    order, lo, hi = st("windows", lambda: reference_windows(s, ref_hashes))
    ref_mat = st("ref_matrix", lambda: reference_matrix(s, ref_hashes, order))
    cands = st("cands", s._ensure_cands_dev)
    state = st("state_h2d", lambda: hc.RefsState(
        ref_mat, s._packed_matrix() if cands is None else cands, lo, hi, s.device,
        n_cands=len(s.entries)))
    words = st("sweep", lambda: sweep_words(hc, state, TOL_INT))
    pi, pj = st("decode_d2h", lambda: decode_pairs(hc, state, words))
    del state, words

    def result_loop():
        keep = ~s.matched[pj]
        results = [[] for _ in ref_hashes]
        for i, j in zip(pi[keep].tolist(), pj[keep].tolist()):
            results[order[i]].append(s.entries[j].src_path)
        return results

    results = st("result_loop", result_loop)
    groups = st("groups", lambda: [MatchGroup.new_with_reference(r.src_path, m)
                                   for r, m in zip(ref_hashes, results) if m])
    return groups, st


def same_pairs(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def seam_check(hc, state, hits, words, pairs) -> dict:
    """The 1M sweep under forced small counts budgets: the slabs' hit tiles
    and K3 words, concatenated, and the pairs must equal the one-slab
    sweep's."""
    slabs = {}
    for budget in SEAM_BUDGETS:
        cut = hc.count_slabs(state, budget)
        require(len(cut) > 1, f"counts budget {budget} gave one slab at 1M")
        s_hits, s_words = [], []
        for rt0, rt1 in cut:
            h = hc.hit_tiles(state, hc.band_counts(state, TOL_INT, rt0, rt1), rt0)
            s_hits.append(h)
            s_words.append(hc.band_pack(state, h, TOL_INT))
        require(torch.equal(torch.cat(s_hits), hits),
                f"budget {budget}: the slabs' hit tiles differ from the one-slab sweep's")
        require(torch.equal(torch.cat(s_words), words),
                f"budget {budget}: the slabs' K3 words differ from the one-slab sweep's")
        got = hc.banded_adjacency_cuda(state, TOL_INT, counts_budget=budget)
        require(same_pairs(got, pairs), f"budget {budget}: pairs differ from the one-slab sweep's")
        slabs[budget] = len(cut)
    return slabs


def scale_8m_phase(dev, vdf, hc, hb) -> dict:
    """``scale_8m``: 8,000,000 hashes of the 1M recipe resident on the card.
    (a) the slabbed K2 + K3 sweep and K4 over one state, pairs exact against
    the planted pairs and against each other; K2's and K3's device time slab
    by slab and K4's range by range; (b) three sampled slabs of K2 and K3
    against the plain versions; (c) the public ``search`` over the resident
    sorted library; (d) ``search_with_references`` of 10,000 references."""
    counters = (hc.band_counts, hc.band_pack, hb.band_sweep)
    t0 = time.perf_counter()
    packed, durations, starts = planted_library(N_SCALE, SEED)
    bounds = self_bounds(durations)
    want = planted_pairs(starts)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = hc.IncrementalDeviceLibrary(dev, capacity=N_SCALE)
    for part in np.array_split(packed, LIBRARY_CHUNKS):
        lib.append(part)
    state = lib.state(np.arange(N_SCALE), bounds)
    torch.cuda.synchronize()
    resident_s = time.perf_counter() - t0
    require(state.packed.data_ptr() == lib.packed.data_ptr(), "scale_8m: the state copied the library")
    comps = state.comparisons()
    slabs = hc.count_slabs(state)
    ranges = hb.band_ranges(state)

    # (a) the public sweeps over the state, counted
    pairs, sweep_s, sweep_peak, sweep_launches = measured(
        lambda: hc.banded_adjacency_cuda(state, TOL_INT), counters, dev)
    require(same_pairs(pairs, want), f"scale_8m: K2 + K3 found {len(pairs[0])} pairs,"
            f" {len(want[0])} planted")
    with_band = sum(bool(state.n_ct[a:b].any()) for a, b in slabs)
    require(sweep_launches["band_counts"] == with_band and len(slabs) > 1
            and 1 <= sweep_launches["band_pack"] <= with_band and sweep_launches["band_sweep"] == 0,
            f"scale_8m: {len(slabs)} slabs, launches {sweep_launches}")
    band_pairs, band_s, band_peak, band_launches = measured(
        lambda: hb.banded_adjacency_band(None, None, TOL_INT, state=state), counters, dev)
    require(same_pairs(band_pairs, pairs), f"scale_8m: K4 found {len(band_pairs[0])} pairs")
    require(band_launches == {"band_counts": 0, "band_pack": 0, "band_sweep": len(ranges)},
            f"scale_8m: {len(ranges)} ranges, launches {band_launches}")
    # the kernels' own time: K2 and K3 slab by slab, K4 range by range
    k2_ms = k3_ms = k4_ms = 0.0
    n_hits, cells = 0, 0
    for rt0, rt1 in slabs:
        cnt, ms = timed(lambda: hc.band_counts(state, TOL_INT, rt0, rt1))
        k2_ms += ms
        cells = max(cells, cnt.numel())
        hits = hc.hit_tiles(state, cnt, rt0)
        _, ms = timed(lambda: hc.band_pack(state, hits, TOL_INT))
        k3_ms += ms
        n_hits += hits.shape[0]
        del cnt
    for rt0, rt1 in ranges:
        k4_ms += timed(lambda: hb.band_sweep(state, TOL_INT, rt0, rt1))[1]
    k2_bound_ms, k2_by = k2_bound(state)
    k4_bound_ms, _ = bound(
        sweep_inputs(state) + state.n_row_tiles * state.slots * 4 + n_hits * hc.TILE * 16,
        2 * 1024 * comps, INT8_OPS_PER_S)
    phase("scale_8m_a", bound="exact", hashes=N_SCALE, make_library_s=round(make_s, 2),
          resident_s=round(resident_s, 3), comparisons=comps, pairs=len(pairs[0]),
          planted_pairs=len(want[0]), row_tiles=state.n_row_tiles, slots=state.slots,
          slabs=len(slabs), slab_counts_bytes=4 * cells,
          one_state_counts_bytes=4 * state.n_row_tiles * state.slots,
          sweep_s=round(sweep_s, 3), comps_per_s=f"{comps / sweep_s:.4g}",
          peak_bytes=sweep_peak, launches=json.dumps(sweep_launches),
          counts_ms=round(k2_ms, 2), counts_bound_ms=round(k2_bound_ms, 2),
          counts_bound_by=k2_by, counts_bound_share=round(k2_bound_ms / k2_ms, 4),
          hit_tiles=n_hits, pack_call_ms=round(k3_ms, 3),
          band_sweep_s=round(band_s, 3), band_comps_per_s=f"{comps / band_s:.4g}",
          band_ranges=len(ranges), band_peak_bytes=band_peak,
          band_launches=json.dumps(band_launches), band_kernel_ms=round(k4_ms, 2),
          band_bound_share=round(k4_bound_ms / k4_ms, 4))

    # the same resident library through the ring on 4 shards of the card
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda

    ring, ring_s, ring_peak, ring_launches = measured(
        lambda: ring_cuda.banded_adjacency_ring(lib.packed, bounds, TOL_INT, mesh=card_mesh(dev, 4),
                                                n=N_SCALE), counters, dev)
    require(same_pairs(ring, pairs), f"ring_8m: {len(ring[0])} pairs, the slabbed sweep {len(pairs[0])}")
    require(ring_launches["band_counts"] >= 4 and ring_launches["band_sweep"] == 0,
            f"ring_8m: launches {ring_launches}")
    phase("ring_8m", bound="exact", shards=4, pairs=len(ring[0]), seconds=round(ring_s, 3),
          slabbed_sweep_s=round(sweep_s, 3), ratio=round(ring_s / sweep_s, 3), peak_bytes=ring_peak,
          launches=json.dumps(ring_launches), **ring_fields(ring_cuda.LAST_RING_PHASES))
    del ring
    # ... and over every card: the blocks go from the resident library to their cards
    cards = cards_mesh()
    ring_cards_launches = None
    if cards is None:
        phase("ring_8m_distinct_cards", distinct_cards=repr("skipped: 1 card"))
    else:
        ring, cards_s, cards_peak, ring_cards_launches = measured(
            lambda: ring_cuda.banded_adjacency_ring(lib.packed, bounds, TOL_INT, mesh=cards, n=N_SCALE),
            counters, dev)
        require(same_pairs(ring, pairs), f"ring_8m_distinct_cards: {len(ring[0])} pairs,"
                f" the slabbed sweep {len(pairs[0])}")
        require(ring_cards_launches["band_counts"] >= cards.size and ring_cards_launches["band_sweep"] == 0,
                f"ring_8m_distinct_cards: launches {ring_cards_launches}")
        phase("ring_8m_distinct_cards", bound="exact", mesh=repr(cards), pairs=len(ring[0]),
              seconds=round(cards_s, 3), slabbed_sweep_s=round(sweep_s, 3),
              ratio=round(cards_s / sweep_s, 3), card0_peak_bytes=cards_peak,
              launches=json.dumps(ring_cards_launches), **ring_fields(ring_cuda.LAST_RING_PHASES))
        del ring

    # (b) K2 and K3 on three sampled slabs against the plain versions: the
    # row tiles around the first, the middle and the last planted cluster,
    # at the search's tolerance and at a loose one (random pairs lie at
    # 500 +/- 16 bits, so most tiles then hold matches)
    R = state.n_row_tiles
    sampled = {}
    by_row = np.sort(starts)
    for name, s in (("first", by_row[0]), ("middle", by_row[len(by_row) // 2]), ("last", by_row[-1])):
        rt0 = min(int(s) // hc.TILE, R - SAMPLE_ROW_TILES)
        rt1 = rt0 + SAMPLE_ROW_TILES
        # every band tile of the slab's first row tile, whatever it holds
        row0 = torch.stack([torch.full((int(state.n_ct[rt0]),), rt0, device=dev),
                            int(state.first_ct[rt0]) + torch.arange(int(state.n_ct[rt0]), device=dev)],
                           dim=1).to(torch.int32)
        pairs = {}
        for tol in (TOL_INT, SAMPLE_TOL_LOOSE):
            ck = hc.band_counts(state, tol, rt0, rt1)
            cp = hc.band_counts_plain(state, tol, rt0, rt1)
            require(ck.shape == cp.shape and torch.equal(ck, cp),
                    f"scale_8m: K2 over row tiles [{rt0}, {rt1}) at {tol} differs from the plain version")
            tiles = row0 if tol != TOL_INT else torch.cat([hc.hit_tiles(state, cp, rt0), row0]).contiguous()
            err = bit_diff(hc.band_pack(state, tiles, tol), hc.band_pack_plain(state, tiles, tol))
            require(err == 0, f"scale_8m: K3 over row tiles [{rt0}, {rt1}) at {tol} differs by {err} bits")
            pairs[tol] = int(cp.sum())
            del ck, cp
        require(pairs[TOL_INT] >= CLUSTER_SIZE and pairs[SAMPLE_TOL_LOOSE] > pairs[TOL_INT],
                f"scale_8m: sampled slab [{rt0}, {rt1}) holds {pairs} pairs")
        sampled[name] = dict(row_tiles=[rt0, rt1], band_tiles=int(state.n_ct[rt0:rt1].sum()),
                             pairs=pairs[TOL_INT], loose_pairs=pairs[SAMPLE_TOL_LOOSE],
                             pack_tiles=row0.shape[0])
    phase("scale_8m_b", bound=f"exact at {TOL_INT} and {SAMPLE_TOL_LOOSE}", sampled=json.dumps(sampled))

    # (c) the public search over the resident, sorted library
    g0, t0 = GC.seconds, time.perf_counter()
    paths = [f"s{i:07d}" for i in range(N_SCALE)]
    paths_s, paths_gc_s = time.perf_counter() - t0, GC.seconds - g0
    g0, t0 = GC.seconds, time.perf_counter()
    hashes = vdf.VideoHash.many_from_packed_u32(packed, paths, durations)
    objects_s, objects_gc_s = time.perf_counter() - t0, GC.seconds - g0
    g0 = GC.seconds
    planted = {frozenset(paths[s + k] for k in range(CLUSTER_SIZE)) for s in starts}
    between_gc_s = GC.seconds - g0  # collections the new objects brought on before the search
    groups, search_s, search_peak, search_launches = measured(
        lambda: vdf.search(hashes, TOLERANCE, device_library=lib, device=dev), counters, dev)
    search_gc_s = GC.last
    stepped, c_steps = search_steps(hc, hashes, dev, lib)
    require(stepped == groups, "scale_8m: the stepwise search gave other groups")
    found = groups_as_sets(groups)
    require(found == planted, f"scale_8m: search found {len(found & planted)} of"
            f" {len(planted)} planted groups ({len(found)} found)")
    require(search_launches["band_counts"] == with_band and search_launches["band_sweep"] == 0,
            f"scale_8m: search launches {search_launches}")
    phase("scale_8m_c", groups=len(groups), planted_found=len(found & planted),
          paths_s=round(paths_s, 3), paths_gc_s=round(paths_gc_s, 3),
          objects_s=round(objects_s, 3), objects_gc_s=round(objects_gc_s, 3),
          after_objects_gc_s=round(between_gc_s, 3),
          search_s=round(search_s, 3), search_gc_s=round(search_gc_s, 4), **c_steps.fields(),
          sweep_s=round(sweep_s, 3), host_s=round(search_s - sweep_s, 3),
          peak_bytes=search_peak, launches=json.dumps(search_launches))

    # (d) 10,000 references, every 100th a copy of a candidate outside the clusters
    rng = np.random.default_rng(SEED + 2)
    ref_durs = np.sort(rng.integers(30, 7200, N_REFS))
    lo = np.searchsorted(durations, (ref_durs * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(durations, (ref_durs * 1.05).astype(np.int64), "right")
    refs = rng.integers(0, 2**32, (N_REFS, 32), dtype=np.uint64).astype(np.uint32)
    in_cluster = set((starts[:, None] + np.arange(CLUSTER_SIZE)).ravel().tolist())
    plants = {}
    for k in range(0, N_REFS, REFS_PLANT_EVERY):
        c = int(lo[k])
        while c in in_cluster:
            c += 1
        require(c < hi[k], f"scale_8m: reference {k} has no candidate to copy")
        refs[k] = packed[c]
        plants[f"/r/{k:06}.mp4"] = {paths[c]}
    ref_hashes = vdf.VideoHash.many_from_packed_u32(
        refs, (f"/r/{k:06}.mp4" for k in range(N_REFS)), ref_durs)
    ref_groups, refs_s, refs_peak, refs_launches = measured(
        lambda: vdf.search_with_references(ref_hashes, hashes, TOLERANCE, device_library=lib,
                                           device=dev), counters, dev)
    refs_gc_s = GC.last
    stepped, d_steps = refs_steps(hc, ref_hashes, hashes, dev, lib)
    require(stepped == ref_groups, "scale_8m: the stepwise refs search gave other groups")
    got = {g.reference: set(g.duplicates) for g in ref_groups}
    require(len(plants) == N_REFS // REFS_PLANT_EVERY and got == plants,
            f"scale_8m: refs search found {sum(got.get(k) == v for k, v in plants.items())}"
            f" of the {len(plants)} planted pairs ({len(got)} groups)")
    require(refs_launches["band_counts"] > 0 and refs_launches["band_pack"] > 0,
            f"scale_8m: refs launches {refs_launches}")
    phase("scale_8m_d", refs=N_REFS, candidates=N_SCALE, comparisons=int(np.sum(hi - lo)),
          planted_found=len(got), seconds=round(refs_s, 3), gc_s=round(refs_gc_s, 4),
          **d_steps.fields(), peak_bytes=refs_peak,
          launches=json.dumps(refs_launches))
    return dict(slabs=len(slabs), ranges=len(ranges), sweep=sweep_launches, band=band_launches,
                search=search_launches, refs=refs_launches, ring=ring_launches,
                ring_cards=ring_cards_launches, k2_ms=k2_ms, k2_bound_ms=k2_bound_ms,
                k3_call_ms=k3_ms, hit_tiles=n_hits, k4_ms=k4_ms, k4_bound_ms=k4_bound_ms,
                sweep_s=sweep_s, band_s=band_s, sweep_peak=sweep_peak, band_peak=band_peak)


def card_mesh(dev, shards: int):
    """``shards`` shards on the one card ``dev``: the ring's schedule, copies
    between shards included, on a single GPU."""
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    return Mesh([dev] * shards)


def ring_phases(dev, vdf, hc, packed, bounds, pairs, hashes, groups) -> dict:
    """``ring_1m``: the 1M library through ``banded_adjacency_ring`` on 4 and
    on 16 shards of the card (bands across one block, and across three),
    beside the single-card sweep from the same host matrix in this call;
    over up to 4 distinct cards where the host has them; the public
    ``search(backend="ring")`` on its default mesh (every visible card);
    and, on several cards, ``auto_ring_1m``: ``search()`` with the
    multi-card rule as a user finds it, which must take the ring exactly
    where the rule says so (and, where its default minimum lies above 1M,
    again with ``VDF_RING_MIN_N`` at 1M, where it must).  Returns each
    run's K2/K3 launches."""
    from vid_dup_finder_lib_tpu_torch.ops import hamming as ops_hamming
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import make_mesh

    counters = (hc.band_counts, hc.band_pack)
    single, single_s, single_peak, single_launches = measured(
        lambda: hc.banded_adjacency_cuda(hc.SearchState(packed, bounds, dev), TOL_INT), counters, dev)
    require(same_pairs(single, pairs), "ring_1m: the single-card sweep's pairs changed")
    meshes = {f"{s}_shards": card_mesh(dev, s) for s in RING_SHARDS}
    cards = cards_mesh()
    if cards is not None:
        meshes["distinct_cards"] = cards
    launched = {}
    for name, mesh in meshes.items():
        got, seconds, peak, launches = measured(
            lambda: ring_cuda.banded_adjacency_ring(packed, bounds, TOL_INT, mesh=mesh), counters, dev)
        ph = dict(ring_cuda.LAST_RING_PHASES)
        require(same_pairs(got, pairs), f"ring_1m ({name}): {len(got[0])} pairs, the single-card"
                f" sweep {len(pairs[0])}")
        require(launches["band_counts"] == ph["band_counts"] >= mesh.size and launches["band_pack"] > 0,
                f"ring_1m ({name}): launches {launches}, phases {ph}")
        require(name != "16_shards" or ph["k_max"] >= 2, f"ring_1m (16 shards): k_max {ph['k_max']}")
        launched[name] = launches
        phase(f"ring_1m_{name}", bound="exact", shards=mesh.size, pairs=len(got[0]),
              capacity_ok=ring_cuda.ring_capacity_ok(len(packed), bounds, mesh.size, mesh=mesh),
              seconds=round(seconds, 4), single_card_s=round(single_s, 4),
              ratio=round(seconds / single_s, 3), peak_bytes=peak, single_card_peak_bytes=single_peak,
              launches=json.dumps(launches), single_card_launches=json.dumps(single_launches),
              **ring_fields(ph))
    if cards is None:
        phase("ring_1m_distinct_cards", distinct_cards=repr("skipped: 1 card"))
    ring_groups, seconds, peak, launches = measured(
        lambda: vdf.search(hashes, TOLERANCE, backend="ring", device=dev), counters, dev)
    require(ring_groups == groups, "search(backend='ring'): groups differ from backend='device'")
    require(launches["band_counts"] > 0, f"search(backend='ring'): launches {launches}")
    launched["search"] = launches
    phase("ring_1m_search", groups=len(ring_groups), mesh=repr(make_mesh(device=dev)),
          seconds=round(seconds, 4), peak_bytes=peak, launches=json.dumps(launches))
    if cards is None:
        phase("auto_ring_1m", distinct_cards=repr("skipped: 1 card"))
        return launched
    runs = [None] if N_LIBRARY >= ops_hamming.RING_MIN_N else [None, str(N_LIBRARY)]
    for min_n in runs:
        with environ(VDF_AUTO_RING=None, VDF_RING_MIN_N=min_n):
            rule = N_LIBRARY >= int(min_n or ops_hamming.RING_MIN_N) and ring_cuda.ring_capacity_ok(
                N_LIBRARY, bounds, torch.cuda.device_count())
            ring_cuda.LAST_RING_PHASES = {}
            auto_groups, seconds, peak, launches = measured(
                lambda: vdf.search(hashes, TOLERANCE, device=dev), counters, dev)
        ph = ring_cuda.LAST_RING_PHASES
        require(auto_groups == groups, "auto_ring_1m: groups differ from backend='device'")
        require(bool(ph) == rule, f"auto_ring_1m: the ring ran: {bool(ph)}, the rule says {rule}")
        require(not rule or ph["shards"] == cards.size, f"auto_ring_1m: {ph.get('shards')} shards")
        launched["auto_ring_1m" if min_n is None else "auto_ring_1m_min_1m"] = launches
        phase("auto_ring_1m", ring_min_n=int(min_n or ops_hamming.RING_MIN_N), took_ring=bool(ph),
              groups=len(auto_groups), seconds=round(seconds, 4), card0_peak_bytes=peak,
              launches=json.dumps(launches), **(ring_fields(ph) if ph else {}))
    return launched


def refs_sharded_phase(dev, vdf, hc, refs, cands, lo, hi, pairs, ref_hashes, cand_hashes,
                       ref_groups) -> dict:
    """``refs_sharded_10k_x_1m``: the refs phase's inputs with the references
    split over 4 shards of the card, candidates replicated once per card;
    then the public ``search_with_references`` with ``VDF_REFS_SHARDED=1``
    (its default mesh).  With several cards, ``..._distinct_cards``: the
    references split over every card (the candidates up once, then card to
    card), and the public search with ``VDF_REFS_SHARDED`` unset, which
    stays on one card (the multi-card rule is off: sharded, it lost to one
    card at every size measured).  Returns the K2/K3 launches of each."""
    from vid_dup_finder_lib_tpu_torch.parallel import refs_sharded as rs

    counters = (hc.band_counts, hc.band_pack)
    got, seconds, peak, launches = measured(
        lambda: rs.refs_adjacency_sharded(refs, lo, hi, TOL_INT, cands_packed=cands,
                                          mesh=card_mesh(dev, 4)), counters, dev)
    require(same_pairs(got, pairs), f"refs_sharded: {len(got[0])} pairs, one card {len(pairs[0])}")
    require(launches["band_counts"] == 4 and launches["band_pack"] > 0, f"refs_sharded: {launches}")
    with environ(VDF_REFS_SHARDED="1"):
        public, public_s, public_peak, public_launches = measured(
            lambda: vdf.search_with_references(ref_hashes, cand_hashes, TOLERANCE, device=dev),
            counters, dev)
    require(public == ref_groups and len(public) == N_REFS // REFS_PLANT_EVERY,
            f"refs_sharded: the public search found {len(public)} groups")
    require(public_launches["band_counts"] > 0, f"refs_sharded (public): {public_launches}")
    phase("refs_sharded_10k_x_1m", bound="exact", shards=4, pairs=len(got[0]),
          planted_found=len(public), seconds=round(seconds, 4), peak_bytes=peak,
          launches=json.dumps(launches), public_seconds=round(public_s, 4),
          public_launches=json.dumps(public_launches))
    out = {"shards": launches, "public": public_launches}
    cards = cards_mesh()
    if cards is None:
        phase("refs_sharded_10k_x_1m_distinct_cards", distinct_cards=repr("skipped: 1 card"))
        return out
    got, seconds, peak, launches = measured(
        lambda: rs.refs_adjacency_sharded(refs, lo, hi, TOL_INT, cands_packed=cands, mesh=cards),
        counters, dev)
    require(same_pairs(got, pairs), f"refs_sharded (cards): {len(got[0])} pairs, one card {len(pairs[0])}")
    require(launches["band_counts"] >= cards.size and launches["band_pack"] > 0,
            f"refs_sharded (cards): {launches}")
    calls = []
    real = rs.refs_adjacency_sharded
    rs.refs_adjacency_sharded = lambda *a, **kw: calls.append(kw["mesh"]) or real(*a, **kw)
    try:
        with environ(VDF_REFS_SHARDED=None):
            public, public_s, public_peak, public_launches = measured(
                lambda: vdf.search_with_references(ref_hashes, cand_hashes, TOLERANCE, device=dev),
                counters, dev)
    finally:
        rs.refs_adjacency_sharded = real
    require(public == ref_groups, "refs_sharded (cards): the public search's groups differ")
    require(not calls, "refs_sharded (cards): the public search sharded with VDF_REFS_SHARDED unset")
    phase("refs_sharded_10k_x_1m_distinct_cards", bound="exact", mesh=repr(cards), pairs=len(got[0]),
          seconds=round(seconds, 4), card0_peak_bytes=peak, launches=json.dumps(launches),
          public_sharded=bool(calls), public_seconds=round(public_s, 4),
          public_launches=json.dumps(public_launches))
    out.update(distinct_cards=launches, distinct_cards_public=public_launches)
    return out


def sharded_hash_phase(dev, hash_cubes, cubes, words) -> int:
    """``sharded_hash``: the 65,536 cubes over 4 shards of the card, one K1
    launch each, bit-equal to the single launch's hashes."""
    from vid_dup_finder_lib_tpu_torch.parallel import sharded_hash_batch

    got, seconds, _, launches = measured(
        lambda: sharded_hash_batch(card_mesh(dev, 4), cubes), (hash_cubes,), dev)
    gc_s = GC.last
    require(np.array_equal(got, words.cpu().numpy().view(np.uint32)),
            "sharded_hash: hashes differ from the single launch's")
    require(launches["hash_cubes"] == 4, f"sharded_hash: launches {launches}")
    # the same cubes from host memory: each shard's part goes up on its own
    host_cubes = cubes.cpu().numpy()
    host_got, host_s, _, host_launches = measured(
        lambda: sharded_hash_batch(card_mesh(dev, 4), host_cubes), (hash_cubes,), dev)
    require(np.array_equal(host_got, got), "sharded_hash: host cubes hash otherwise")
    require(host_launches["hash_cubes"] == 4, f"sharded_hash (host): launches {host_launches}")
    phase("sharded_hash", bound="bit-exact", cubes=N_CUBES, shards=4, seconds=round(seconds, 4),
          gc_s=round(gc_s, 4), from_host_s=round(host_s, 4), from_host_gc_s=round(GC.last, 4),
          launches=json.dumps(launches))
    return launches["hash_cubes"]


def ring_scan_phase(dev, packed, durations) -> None:
    """``ring_scan``: ``ring_candidate_scan`` over the first 16,384 hashes
    of the 1M library on 4 shards of the card, at a tolerance loose enough
    that most rows have candidates, held exactly to a NumPy XOR + popcount
    over every row's window."""
    from vid_dup_finder_lib_tpu_torch.parallel import ring_candidate_scan

    p, d = packed[:N_SCAN], durations[:N_SCAN]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts_, best, idx = ring_candidate_scan(card_mesh(dev, 4), p, d, SCAN_TOL)
    seconds = time.perf_counter() - t0
    # the scan's window, its duration threshold in float32 as it takes it
    hi = np.searchsorted(d, (d.astype(np.float32) * np.float32(1.1)).astype(np.int64), "right")
    want = np.zeros(N_SCAN, np.int64), np.full(N_SCAN, 1001), np.full(N_SCAN, -1)
    for i in range(N_SCAN):
        dist = np.bitwise_count(p[i + 1 : hi[i]] ^ p[i]).sum(1)
        ok = dist <= SCAN_TOL
        if ok.any():
            best_i = dist[ok].min()
            want[0][i], want[1][i] = ok.sum(), best_i
            want[2][i] = i + 1 + np.flatnonzero(ok & (dist == best_i))[0]
    for name, a, b in zip(("counts", "best_dist", "best_idx"), (counts_, best, idx), want):
        require(np.array_equal(a, b), f"ring_scan: {name} differs from NumPy's")
    phase("ring_scan", bound="exact", hashes=N_SCAN, shards=4, tol=SCAN_TOL,
          rows_with_candidates=int((counts_ > 0).sum()), candidates=int(counts_.sum()),
          seconds=round(seconds, 4))


def native_cpu_phase(dev, vdf, packed, durations, paths, starts, refs_case) -> None:
    """``native_cpu``: the native host runtime on the card's host.  Builds
    the library with g++, searches the first 100,000 rows of the 1M library
    with ``backend="native"`` on ``device="cpu"`` against the card's
    ``search`` on the same rows, and holds ``refs_windowed_native`` and
    ``distances_one_native`` to the card's references sweep on a sample."""
    from vid_dup_finder_lib_tpu_torch import native
    from vid_dup_finder_lib_tpu_torch.ops.hamming import refs_adjacency

    t0 = time.perf_counter()
    require(native.available(), "native_cpu: the native library did not build")
    build_s = time.perf_counter() - t0
    macros = subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                            capture_output=True, text=True, check=True).stdout
    with open("/proc/cpuinfo") as f:
        cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), "?")
    sub = vdf.VideoHash.many_from_packed_u32(
        packed[:N_NATIVE], paths[:N_NATIVE], durations[:N_NATIVE])
    planted = {frozenset(paths[s + k] for k in range(CLUSTER_SIZE))
               for s in starts if s + CLUSTER_SIZE <= N_NATIVE}
    comps = int(np.maximum(self_bounds(durations[:N_NATIVE]) - np.arange(1, N_NATIVE + 1), 0).sum())
    t0 = time.perf_counter()
    host_groups = vdf.search(sub, TOLERANCE, backend="native", device="cpu")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto_groups = vdf.search(sub, TOLERANCE, device="cpu")
    auto_s = time.perf_counter() - t0
    card_groups = vdf.search(sub, TOLERANCE, device=dev)
    require(groups_as_sets(host_groups) == planted and len(planted) > 0,
            f"native_cpu: {len(groups_as_sets(host_groups) & planted)} of {len(planted)} planted groups")
    require(host_groups == card_groups and auto_groups == card_groups,
            "native_cpu: the native search's groups differ from the card's")
    refs, cands, lo, hi = refs_case
    t0 = time.perf_counter()
    ni, nj = native.refs_windowed_native(
        refs.view(np.uint64), cands.view(np.uint64), lo, hi, TOL_INT)
    refs_s = time.perf_counter() - t0
    ci, cj = refs_adjacency(refs, cands, lo, hi, TOL_INT, device=dev)
    require(len(ni) > 0 and np.array_equal(ni, ci) and np.array_equal(nj, cj),
            f"native_cpu: windowed sweep {len(ni)} pairs, the card {len(ci)}")
    k = int(ni[0])  # a reference with a match: its distances name the same candidates
    dist = native.distances_one_native(refs[k], cands[lo[k] : hi[k]])
    require(np.array_equal(dist, np.bitwise_count(cands[lo[k] : hi[k]] ^ refs[k]).sum(1)),
            "native_cpu: distances differ from NumPy's popcount")
    require((np.nonzero(dist <= TOL_INT)[0] + lo[k]).tolist() == cj[ci == k].tolist(),
            "native_cpu: distances within tolerance name other candidates than the card")
    refs_comps = int(np.sum(hi - lo))
    phase("native_cpu", bound="exact", gxx_seconds=round(build_s, 3),
          avx512_vpopcntdq="__AVX512VPOPCNTDQ__" in macros, cpu=repr(cpu),
          threads=os.cpu_count(), rows=N_NATIVE, comparisons=comps, groups=len(host_groups),
          search_s=round(native_s, 4), auto_search_s=round(auto_s, 4),
          comps_per_s=f"{comps / native_s:.4g}", includes="Search.__init__ and the replay",
          refs=len(refs), refs_comparisons=refs_comps, refs_pairs=len(ni),
          refs_sweep_s=round(refs_s, 4), refs_comps_per_s=f"{refs_comps / refs_s:.4g}")


def device_preproc_phase(dev, hash_cubes) -> int:
    """``device_preproc_1080p``: the synthetic 1080p videos in the
    pipeline's 512 MiB batches through ``hash_raw_frames_device`` (h2d from
    pinned memory, letterbox, resize, K1), then each stage alone on the
    uploaded batch; crops held to the host detector for every video, cubes
    and hashes to the golden model for the first four.  Returns the hash
    kernel's launches in the public calls."""
    from vid_dup_finder_lib_tpu_torch.models import pipeline
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
    public_s, public_gc_s, launched, batch_s, upload_s = 0.0, 0.0, 0, [], []
    for batch in batches:
        host = np.stack([make_video(i) for i in batch])
        torch.cuda.synchronize()
        before = hash_cubes.launches
        g0 = GC.seconds
        t0 = time.perf_counter()
        out = hash_raw_frames_device(host, device=dev)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        public_s += batch_s[-1]
        public_gc_s += GC.seconds - g0
        launched += hash_cubes.launches - before
        # the public call's upload step alone (host clock, synchronised)
        t0 = time.perf_counter()
        uploaded = pipeline._to_device(host, dev)
        torch.cuda.synchronize()
        upload_s.append(time.perf_counter() - t0)
        require(torch.equal(uploaded.cpu(), torch.from_numpy(host)), "the upload changed the frames")
        del uploaded
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
          golden_hash_max_bits=worst, public_s=round(public_s, 4), gc_s=round(public_gc_s, 4),
          batch_s=json.dumps([round(x, 4) for x in batch_s]),
          upload_s=json.dumps([round(x, 4) for x in upload_s]),
          videos_per_s=f"{N_VIDEOS / public_s:.4g}", public_includes="the upload (pinned) + h2d",
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
    GC.start()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), smi=repr(smi))

    # the one-card phases stay on one card on a host with several: the
    # multi-card rules are off except inside auto_ring_1m and the
    # distinct-card references phase, which turn them on
    os.environ["VDF_AUTO_RING"] = "0"
    os.environ["VDF_REFS_SHARDED"] = "0"

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
    # the first search's adjacency (state, sweep, decode: it ends on the
    # host) timed apart, by a wrapper that adds no synchronisation; inside
    # it the sweep state (synchronised after it) and the decode
    first = {"adjacency": 0.0, "state_h2d": 0.0, "decode": 0.0}
    real_adjacency = vdf.Search._ensure_adjacency
    real_state_init = hc.SearchState.__init__
    real_decode = hc.decode_words

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            if name != "adjacency":
                torch.cuda.synchronize()
            first[name] += time.perf_counter() - t
            return out
        return wrapper

    t0 = time.perf_counter()
    words = hash_cubes(cubes)
    g0, t_objects = GC.seconds, time.perf_counter()
    hashes = vdf.VideoHash.many_from_packed_u32(packed, paths, durations)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    objects_gc_s, g0 = GC.seconds - g0, GC.seconds
    vdf.Search._ensure_adjacency = timed("adjacency", real_adjacency)
    hc.SearchState.__init__ = timed("state_h2d", real_state_init)
    hc.decode_words = timed("decode", real_decode)
    try:
        groups = vdf.search(hashes, TOLERANCE, device=dev)
        torch.cuda.synchronize()
    finally:
        vdf.Search._ensure_adjacency = real_adjacency
        hc.SearchState.__init__ = real_state_init
        hc.decode_words = real_decode
    e2e_s = time.perf_counter() - t0
    search_s = time.perf_counter() - t1
    search_gc_s = GC.seconds - g0
    launches = {fn.__name__: fn.launches for fn in counters}
    found = groups_as_sets(groups)
    require(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    require(found == planted, f"1M search found {len(found)} groups, "
            f"{len(found & planted)} of the {len(planted)} planted")
    # the public search again, warm: its wall time as a user sees it
    g0 = GC.seconds
    t0 = time.perf_counter()
    again = vdf.search(hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    search_again_s = time.perf_counter() - t0
    again_gc_s = GC.seconds - g0
    require(again == groups, "a second public search gave other groups")
    # ... and once more, warm, step by step
    stepped, steps = search_steps(hc, hashes, dev)
    require(stepped == groups, "the stepwise search gave other groups")
    phase("main_path", seconds=round(e2e_s, 3), objects_s=round(t1 - t_objects, 4),
          search_s=round(search_s, 4), search_gc_s=round(search_gc_s, 4),
          search_adjacency_s=round(first["adjacency"], 4),
          search_adjacency_parts_s=json.dumps({k: round(v, 4) for k, v in first.items() if k != "adjacency"}),
          search_again_s=round(search_again_s, 4), search_again_gc_s=round(again_gc_s, 4),
          objects_gc_s=round(objects_gc_s, 4), **steps.fields(), groups=len(found),
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
    # one K3 launch is shorter than its wrapper's host work, which the time
    # above includes; queued behind K2 the launches run back to back
    k3_queued_ms = queued_ms(lambda: hc.band_pack(state, hits, TOL_INT),
                             lambda: hc.band_counts(state, TOL_INT))
    n_hits = hits.shape[0]
    k3_bound_ms, k3_bound_by = k3_bound(state, hits)
    reset(counters)
    t0 = time.perf_counter()
    pairs_i, pairs_j = hc.banded_adjacency_cuda(state, TOL_INT)
    sweep_s = time.perf_counter() - t0
    require(hc.count_slabs(state) == [(0, state.n_row_tiles)] and hc.band_counts.launches == 1,
            f"the default counts budget gives one slab and one K2 launch at 1M: {counts(counters)}")
    t0 = time.perf_counter()
    pi, pj = hc.banded_adjacency_plain(state, TOL_INT)
    sweep_plain_s = time.perf_counter() - t0
    require(np.array_equal(pairs_i, pi) and np.array_equal(pairs_j, pj),
            f"1M pairs: kernel {len(pairs_i)} vs plain {len(pi)}")
    seam_slabs = seam_check(hc, state, hits, wk3, (pairs_i, pairs_j))
    phase("search_1m", seam_slabs=json.dumps(seam_slabs), bound="exact", comparisons=comps, pairs=len(pairs_i), hit_tiles=hits.shape[0],
          sweep_s=round(sweep_s, 4), sweep_plain_s=round(sweep_plain_s, 4),
          comps_per_s=f"{comps / sweep_s:.4g}",
          counts_ms=round(k2_ms, 3), counts_plain_ms=round(k2_plain_ms, 3),
          counts_bound_ms=round(k2_bound_ms, 3), counts_bound_by=k2_bound_by,
          counts_bound_share=round(k2_bound_ms / k2_ms, 4), counts_max_abs_err=k2_err,
          pack_ms=round(k3_ms, 4), pack_queued_ms=round(k3_queued_ms, 4),
          pack_plain_ms=round(k3_plain_ms, 3),
          pack_bound_ms=round(k3_bound_ms, 5),
          pack_bound_share=round(k3_bound_ms / k3_queued_ms, 4),
          launches=json.dumps({fn.__name__: fn.launches for fn in counters}))

    # ---- K3 where every tile of the list is computed: all band tiles of a
    # run of row tiles in the middle of the 1M library, beside K2's time per
    # tile over the whole band (both per SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    full_hits = band_tiles(hc, state, state.n_row_tiles // 2, FULL_LIST_TILES)
    n_full = full_hits.shape[0]
    full_words = hc.band_pack(state, full_hits, TOL_INT)
    sample = torch.arange(0, n_full, FULL_LIST_SAMPLE, device=dev)
    k3_full_err = bit_diff(full_words[sample],
                           hc.band_pack_plain(state, full_hits[sample], TOL_INT))
    require(k3_full_err == 0, f"full hit list: words differ by up to {k3_full_err} bits")
    # ... and every tile's popcount to K2's count of that tile
    full_counts = torch.from_numpy(np.bitwise_count(
        full_words.cpu().numpy().view(np.uint32)).reshape(n_full, -1).sum(1, dtype=np.int64)).to(dev)
    rts = full_hits[:, 0].long()
    require(torch.equal(full_counts, ck[rts, full_hits[:, 1].long() - state.first_ct_dev[rts]].long()),
            "full hit list: a tile's words hold another number of pairs than K2 counted")
    full_pairs = int(full_counts.sum())
    del full_words
    k3_full_ms = cuda_ms(lambda: hc.band_pack(state, full_hits, TOL_INT))
    k3_full_bound_ms, _ = k3_bound(state, full_hits)
    band_tile_count = int(state.n_ct.sum())
    k3_full_us = k3_full_ms * 1e3 * sms / n_full
    k2_us = k2_ms * 1e3 * sms / band_tile_count
    phase("pack_full", bound=f"exact on 1 tile in {FULL_LIST_SAMPLE}, popcounts equal K2's on all", tiles=n_full,
          row_tiles=int(full_hits[-1, 0] - full_hits[0, 0]) + 1, sampled=sample.shape[0],
          pairs=full_pairs, pack_ms=round(k3_full_ms, 4),
          pack_us_per_tile_per_sm=round(k3_full_us, 4),
          counts_us_per_tile_per_sm=round(k2_us, 4), counts_band_tiles=band_tile_count,
          sms=sms, bound_ms=round(k3_full_bound_ms, 4),
          bound_share=round(k3_full_bound_ms / k3_full_ms, 4))
    del full_hits

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
        # K3 on this library's own hit list, word for word
        lhits = hc.hit_tiles(st, hc.band_counts(st, TOL_INT))
        lerr = bit_diff(hc.band_pack(st, lhits, TOL_INT), hc.band_pack_plain(st, lhits, TOL_INT))
        require(lerr == 0, f"{name}: packed words differ by up to {lerr} bits")
        k3_err = max(k3_err, lerr)
        extra = {}
        if name == "dense":
            dense_hits = lhits.shape[0]
            k3_dense_ms = cuda_ms(lambda: hc.band_pack(st, lhits, TOL_INT))
            k3_dense_queued_ms = queued_ms(lambda: hc.band_pack(st, lhits, TOL_INT),
                                           lambda: hc.band_counts(state, TOL_INT))
            k3_dense_plain_ms = cuda_ms(lambda: hc.band_pack_plain(st, lhits, TOL_INT), reps=3)
            k3_dense_bound_ms, _ = k3_bound(st, lhits)
            extra = dict(pack_ms=round(k3_dense_ms, 4), pack_queued_ms=round(k3_dense_queued_ms, 4),
                         pack_us_per_tile=round(k3_dense_queued_ms * 1e3 / dense_hits, 4),
                         pack_us_per_tile_per_sm=round(
                             k3_dense_queued_ms * 1e3 * sms / dense_hits, 4),
                         pack_plain_ms=round(k3_dense_plain_ms, 3),
                         pack_bound_ms=round(k3_dense_bound_ms, 5),
                         pack_bound_share=round(k3_dense_bound_ms / k3_dense_queued_ms, 4))
        if name == "pad_bits":
            hi, hj = banded_adjacency(lib, lb, TOL_INT, backend="host")
            require(np.array_equal(ki, hi) and np.array_equal(kj, hj),
                    f"{name}: kernel {len(ki)} pairs vs host {len(hi)}")
        require(len(ki) > 0, f"{name}: no pairs")
        phase(name, hashes=lib.shape[0], pairs=len(ki), hit_tiles=lhits.shape[0],
              pack_max_abs_err=lerr, **extra)

    # ---- references search: 10k refs x 1M candidates, public API, counted
    refs, ref_durs, cands, cand_durs, lo, hi, plants = refs_inputs(SEED)
    cand_hashes = vdf.VideoHash.many_from_packed_u32(
        cands, (f"/v/{i:08}.mp4" for i in range(N_LIBRARY)), cand_durs)
    ref_hashes = vdf.VideoHash.many_from_packed_u32(
        refs, (f"/r/{k:06}.mp4" for k in range(N_REFS)), ref_durs)
    refs_comps = int(np.sum(hi - lo))
    for fn in band_counters:
        fn.launches = 0
    g0 = GC.seconds
    t0 = time.perf_counter()
    ref_groups = vdf.search_with_references(ref_hashes, cand_hashes, TOLERANCE, device=dev)
    torch.cuda.synchronize()
    refs_e2e_s = time.perf_counter() - t0
    refs_gc_s = GC.seconds - g0
    refs_launches = {fn.__name__: fn.launches for fn in band_counters}
    stepped, refs_breakdown = refs_steps(hc, ref_hashes, cand_hashes, dev)
    require(stepped == ref_groups, "refs: the stepwise search gave other groups")
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
    k3_refs_queued_ms = queued_ms(lambda: hc.band_pack(rst, rhits, TOL_INT),
                                  lambda: hc.band_counts(state, TOL_INT))
    k3_refs_plain_ms = cuda_ms(lambda: hc.band_pack_plain(rst, rhits, TOL_INT))
    phase("refs_10k_x_1m", bound="exact", refs=N_REFS, candidates=N_LIBRARY,
          comparisons=refs_comps, groups=len(ref_groups), planted_found=len(got),
          seconds=round(refs_e2e_s, 3), gc_s=round(refs_gc_s, 4), **refs_breakdown.fields(),
          sweep_s=round(refs_sweep_s, 4),
          comps_per_s=f"{refs_comps / refs_sweep_s:.4g}", ref_tiles=rst.n_row_tiles,
          slots=rst.slots, hit_tiles=rhits.shape[0],
          counts_ms=round(k2_refs_ms, 3), counts_plain_ms=round(k2_refs_plain_ms, 3),
          counts_bound_ms=round(k2_refs_bound_ms, 4),
          counts_bound_share=round(k2_refs_bound_ms / k2_refs_ms, 4),
          counts_max_abs_err=k2_refs_err, pack_ms=round(k3_refs_ms, 4),
          pack_queued_ms=round(k3_refs_queued_ms, 4),
          pack_plain_ms=round(k3_refs_plain_ms, 3),
          launches=json.dumps(refs_launches))

    # ---- the multi-device layer on shards of the card
    ring_launches = ring_phases(dev, vdf, hc, packed, bounds, (pairs_i, pairs_j), hashes, groups)
    refs_sharded_launches = refs_sharded_phase(dev, vdf, hc, refs, cands, lo, hi, (ri, rj),
                                               ref_hashes, cand_hashes, ref_groups)
    sharded_hash_launches = sharded_hash_phase(dev, hash_cubes, cubes, words)
    ring_scan_phase(dev, packed, durations)

    # ---- library_1m: the same searches over a growing device-resident library
    two_phase = (hc.band_counts, hc.band_pack)
    lib_launches = {}

    def library_run(name, fn, lib_counters=two_phase):
        """Run ``fn`` counted (:func:`measured`); the kernels of
        ``lib_counters`` must have launched."""
        out, seconds, peak, launched = measured(fn, band_counters, dev)
        require(all(launched[fn.__name__] > 0 for fn in lib_counters),
                f"library_1m ({name}): kernels launched {launched}")
        lib_launches[name] = launched
        return out, dict(seconds=round(seconds, 4), gc_s=round(GC.last, 4), peak_bytes=peak,
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
    stepped, a_steps = search_steps(hc, hashes, dev, lib, lib_paths)
    require(stepped == groups, "library (a): the stepwise search gave other groups")
    phase("library_1m_a", insertion="shuffled", appends=LIBRARY_CHUNKS,
          append_s=round(append_s, 4), capacity=lib.capacity, groups=len(a_groups),
          planted_found=len(groups_as_sets(a_groups) & planted), **a, **a_steps.fields())
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
    stepped, b_steps = search_steps(hc, hashes, dev, lib)
    require(stepped == groups, "library (b): the stepwise search gave other groups")
    bb_groups, bb = library_run("b_band", lambda: vdf.search(
        hashes, TOLERANCE, backend="band", device_library=lib, device=dev),
        lib_counters=(hb.band_sweep,))
    require(states[-1].packed.data_ptr() == lib.packed.data_ptr(),
            "library (b, band): the identity-order state copied the buffer")
    require(bb_groups == groups, "library (b, band): groups unequal to the upload path's")
    phase("library_1m_b", insertion="sorted", zero_copy=zero_copy, groups=len(b_groups),
          band_groups=len(bb_groups), band_seconds=bb["seconds"],
          band_peak_bytes=bb["peak_bytes"], band_launches=bb["launches"], **b, **b_steps.fields())

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

    native_cpu_phase(dev, vdf, packed, durations, paths, starts,
                     (refs[:N_NATIVE_REFS], cands, lo[:N_NATIVE_REFS], hi[:N_NATIVE_REFS]))
    del cand_hashes, ref_hashes, cands, rst
    scale = scale_8m_phase(dev, vdf, hc, hb)

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
                                 "cli": cli["hash_cubes"], "sharded_hash": sharded_hash_launches}),
        dict(name="band_counts_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:559",
             launches=launches["band_counts"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_bound_by,
             library_ms=None, bound_share=k2_bound_ms / k2_ms,
             refs_launches=refs_launches["band_counts"], refs_max_abs_err=k2_refs_err,
             refs_ms=k2_refs_ms, refs_plain_ms=k2_refs_plain_ms, refs_bound_ms=k2_refs_bound_ms,
             scale_8m_ms=scale["k2_ms"], scale_8m_bound_ms=scale["k2_bound_ms"],
             scale_8m_slabs=scale["slabs"],
             new_phase_launches={
                 **{f"library_1m_{k}": v["band_counts"] for k, v in lib_launches.items()},
                 **{f"scale_8m_{k}": scale[k]["band_counts"] for k in ("sweep", "search", "refs")},
                 **{phase_name("ring_1m", k): v["band_counts"] for k, v in ring_launches.items()},
                 **{f"refs_sharded_10k_x_1m_{k}": v["band_counts"] for k, v in refs_sharded_launches.items()},
                 "ring_8m": scale["ring"]["band_counts"],
                 **({"ring_8m_distinct_cards": scale["ring_cards"]["band_counts"]}
                    if scale["ring_cards"] else {})}),
        dict(name="band_pack_kernel", route="cuda", source=csrc + "hamming_band.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_pallas.py:130",
             launches=launches["band_pack"], max_abs_err=k3_err,
             ms=k3_queued_ms, call_ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound_ms,
             bound_by=k3_bound_by, library_ms=None, bound_share=k3_bound_ms / k3_queued_ms,
             hit_tiles=n_hits,
             refs_launches=refs_launches["band_pack"], refs_max_abs_err=k3_refs_err,
             refs_ms=k3_refs_queued_ms, refs_call_ms=k3_refs_ms, refs_plain_ms=k3_refs_plain_ms,
             dense_ms=k3_dense_queued_ms, dense_call_ms=k3_dense_ms, dense_hit_tiles=dense_hits,
             dense_bound_ms=k3_dense_bound_ms, dense_plain_ms=k3_dense_plain_ms,
             full_ms=k3_full_ms, full_tiles=n_full, full_bound_ms=k3_full_bound_ms,
             full_max_abs_err=k3_full_err, full_us_per_tile_per_sm=k3_full_us,
             counts_us_per_tile_per_sm=k2_us,
             scale_8m_call_ms=scale["k3_call_ms"], scale_8m_hit_tiles=scale["hit_tiles"],
             new_phase_launches={
                 **{f"library_1m_{k}": v["band_pack"] for k, v in lib_launches.items()},
                 **{f"scale_8m_{k}": scale[k]["band_pack"] for k in ("sweep", "search", "refs")},
                 **{phase_name("ring_1m", k): v["band_pack"] for k, v in ring_launches.items()},
                 **{f"refs_sharded_10k_x_1m_{k}": v["band_pack"] for k, v in refs_sharded_launches.items()},
                 "ring_8m": scale["ring"]["band_pack"],
                 **({"ring_8m_distinct_cards": scale["ring_cards"]["band_pack"]}
                    if scale["ring_cards"] else {})}),
        dict(name="band_sweep_kernel", route="cuda", source=csrc + "band_sweep.cu",
             replaces="vid_dup_finder_lib_tpu/ops/hamming_band.py:50",
             launches=band_launches["band_sweep"], max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=k4_bound_ms, bound_by=k4_bound_by,
             library_ms=None, bound_share=k4_bound_ms / k4_ms,
             scale_8m_ms=scale["k4_ms"], scale_8m_bound_ms=scale["k4_bound_ms"],
             scale_8m_ranges=scale["ranges"],
             new_phase_launches={
                 **{f"library_1m_{k}": v["band_sweep"] for k, v in lib_launches.items()},
                 "scale_8m_band": scale["band"]["band_sweep"]}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
