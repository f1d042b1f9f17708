"""The hash library a configuration describes, made from a seed.

A library is ``n`` packed 1000-bit hashes (``uint32[n, 32]``, the 24 pad
bits of the last word zero), their durations in whole seconds (drawn as
:func:`draw_durations` says, sorted) and one path per hash (``/library/v<row>.mp4``,
so the rows are in (duration, path) order).  Random hashes lie about 500
bits apart, so what a search finds is what was planted:

* ``clusters`` groups of ``cluster_size`` rows at one duration, each copy
  ``cluster_radius`` bits from the first row (the recipe of the JAX
  package's ``bench.py`` ``synth_library``);
* ``boundary_pairs`` pairs at one duration whose copy lies exactly
  ``threshold`` bits from its base, and as many at ``threshold + 1``: one
  bit inside and one bit outside the tolerance;
* ``edge_pairs`` bases, each with one copy at duration ``int(d * factor)``,
  the last duration inside the self-search window, and one at that plus
  one second, the first outside it; copies ``edge_radius`` bits away.
  They lie up to a tenth of the library apart in rows, so they also span
  the blocks that a search split over cards exchanges.

Everything is drawn from one ``numpy`` generator seeded by ``--seed``:
the same seed gives the same library.  Nothing here imports the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

WORDS = 32
PAD_MASK = np.uint32(0xFF)  # bits 992..999 of the last word are the hash's
PATH_PREFIX = b"/library/v"
PATH_SUFFIX = b".mp4"
PATH_DIGITS = 8


@dataclass
class Library:
    packed: np.ndarray  # uint32[n, 32]
    durations: np.ndarray  # int64[n], sorted
    paths_bytes: np.ndarray  # S[n], in row order
    # planted groups, each as the row indices the greedy search returns
    # them in: the copies in row order, then the base
    planted: list[tuple[int, ...]]
    # rows (base, copy) whose copy lies one bit outside the tolerance, or
    # one second outside the window: pairs that no search may group
    planted_apart: list[tuple[int, int]]

    @property
    def n(self) -> int:
        return self.packed.shape[0]

    def paths(self) -> list[str]:
        return self.paths_bytes.astype(f"U{self.paths_bytes.itemsize}").tolist()


def threshold(cfg: dict) -> int:
    """The tolerance as a bit count: ``int(tolerance * 1000)``, as the
    upstream crate casts it."""
    return max(0, int(cfg["tolerance"] * cfg["hash_bits"]))


def window_ends(durations: np.ndarray, factor: float) -> np.ndarray:
    """The last duration inside each row's self-search window:
    ``int(d * factor)``, in float64 and truncated, as the crate casts it."""
    return (durations.astype(np.float64) * factor).astype(np.int64)


def self_bounds(durations: np.ndarray, factor: float) -> np.ndarray:
    """For each row of a duration-sorted library, one past the last row
    inside its window: row ``i``'s candidates are ``i < j < bounds[i]``."""
    return np.searchsorted(durations, window_ends(durations, factor), side="right")


def exponential_scale(lo: float, hi: float, mean: float) -> float:
    """The scale of the exponential that, truncated to ``[lo, hi)``, has
    the given mean (bisection; the truncated mean falls as the scale
    shrinks)."""
    if not lo + (hi - lo) / 700 < mean < (lo + hi) / 2:
        raise ValueError(f"a mean of {mean} s needs to lie in ({lo}, {(lo + hi) / 2})")

    def truncated_mean(scale):
        return lo + scale - (hi - lo) / math.expm1((hi - lo) / scale)

    small, large = (hi - lo) / 700, 1e6 * (hi - lo)  # exp(700) still fits a float
    for _ in range(200):
        mid = math.sqrt(small * large)
        small, large = (mid, large) if truncated_mean(mid) < mean else (small, mid)
    return math.sqrt(small * large)


def draw_durations(rng: np.random.Generator, cfg: dict, n: int) -> np.ndarray:
    """``n`` sorted whole-second durations in ``[duration_min_s,
    duration_max_s)`` with the mean ``duration_mean_s``: an exponential
    truncated to the range (of all spreads over a range with a given mean,
    the one of most entropy), drawn by its inverse and floored; the scale
    is fitted half a second higher so that the floored values keep the
    mean."""
    lo, hi = float(cfg["duration_min_s"]), float(cfg["duration_max_s"])
    scale = exponential_scale(lo, hi, float(cfg["duration_mean_s"]) + 0.5)
    u = rng.random(n)
    x = lo - scale * np.log1p(u * np.expm1(-(hi - lo) / scale))
    return np.sort(np.minimum(np.floor(x), hi - 1).astype(np.int64))


def band_pairs(bounds: np.ndarray) -> int:
    """In-band pairs ``i < j < bounds[i]``: the comparisons one self-search
    makes."""
    i = np.arange(bounds.shape[0], dtype=np.int64)
    return int(np.maximum(bounds - i - 1, 0).sum())


def path_array(n: int) -> np.ndarray:
    """``/library/v<row, 8 digits>.mp4`` for every row, as one S array."""
    width = len(PATH_PREFIX) + PATH_DIGITS + len(PATH_SUFFIX)
    chars = np.empty((n, width), np.uint8)
    chars[:, : len(PATH_PREFIX)] = np.frombuffer(PATH_PREFIX, np.uint8)
    chars[:, width - len(PATH_SUFFIX):] = np.frombuffer(PATH_SUFFIX, np.uint8)
    rows = np.arange(n, dtype=np.int64)
    for k in range(PATH_DIGITS - 1, -1, -1):
        chars[:, len(PATH_PREFIX) + k] = rows % 10 + ord("0")
        rows //= 10
    return chars.view(f"S{width}").ravel()


def _flip_masks(rng: np.random.Generator, count: int, flips: int, bits: int) -> np.ndarray:
    """``count`` masks of ``flips`` distinct set bits among the first
    ``bits``, as uint32[count, 32]."""
    masks = np.zeros((count, WORDS), np.uint32)
    if count == 0 or flips == 0:
        return masks
    pos = np.argsort(rng.random((count, bits)), axis=1)[:, :flips]
    rows = np.repeat(np.arange(count), flips)
    pos = pos.ravel()
    np.bitwise_or.at(masks, (rows, pos // 32), np.uint32(1) << (pos % 32).astype(np.uint32))
    return masks


def make_library(cfg: dict, seed: int) -> Library:
    n = int(cfg["hashes"])
    bits = int(cfg["hash_bits"])
    factor = float(cfg["window_factor"])
    thr = threshold(cfg)
    rng = np.random.default_rng([seed & (2**64 - 1), n])
    packed = rng.integers(0, 2**32, size=(n, WORDS), dtype=np.uint32)
    packed[:, -1] &= PAD_MASK
    durations = draw_durations(rng, cfg, n)
    used = np.zeros(n, bool)

    def free(rows) -> bool:
        rows = np.asarray(rows)
        return bool((rows >= 0).all() and (rows < n).all() and not used[rows].any())

    # window-edge pairs first: they move rows to the durations they need
    edge = int(cfg["edge_pairs"])
    ends = window_ends(durations, factor)
    last_base = int(np.searchsorted(durations, (cfg["duration_max_s"] - 2) / factor)) - 1
    edge_rows: list[tuple[int, int, int]] = []
    tries = 0
    while len(edge_rows) < edge:
        tries += 1
        if tries > 100 * edge + 1000:
            raise ValueError(f"cannot place {edge} window-edge pairs in {n} rows")
        i = int(rng.integers(0, max(last_base, 1)))
        d_in = int(ends[i])
        j_in = int(np.searchsorted(durations, d_in, side="left"))
        j_out = max(int(np.searchsorted(durations, d_in + 1, side="left")), j_in + 1)
        near = [i, j_in, j_out]
        if j_in <= i + 1 or not free([r + o for r in near for o in (-1, 0, 1)]):
            continue
        durations[j_in] = d_in  # <= its own, >= the row before's
        durations[j_out] = d_in + 1
        used[[r + o for r in near for o in (-1, 0, 1)]] = True
        edge_rows.append((i, j_in, j_out))

    # clusters and boundary pairs, on blocks of 8 rows clear of the edges
    size = int(cfg["cluster_size"])
    n_cl, n_bd = int(cfg["clusters"]), int(cfg["boundary_pairs"])
    starts: list[int] = []
    for s in rng.permutation(n // 8 - 1) * 8 + 1:
        if len(starts) == n_cl + 2 * n_bd:
            break
        if free(range(s - 1, s + size + 1)):
            used[s - 1 : s + size + 1] = True
            starts.append(int(s))
    if len(starts) < n_cl + 2 * n_bd:
        raise ValueError(f"cannot place {n_cl} clusters and {2 * n_bd} pairs in {n} rows")
    cl_starts, bd_in, bd_out = starts[:n_cl], starts[n_cl : n_cl + n_bd], starts[n_cl + n_bd :]

    planted: list[tuple[int, ...]] = []
    apart: list[tuple[int, int]] = []
    masks = _flip_masks(rng, n_cl * (size - 1), int(cfg["cluster_radius"]), bits)
    for c, s in enumerate(cl_starts):
        for k in range(1, size):
            packed[s + k] = packed[s] ^ masks[c * (size - 1) + k - 1]
            durations[s + k] = durations[s]
        planted.append(tuple(range(s + 1, s + size)) + (s,))
    for group, flips in ((bd_in, thr), (bd_out, thr + 1)):
        masks = _flip_masks(rng, len(group), flips, bits)
        for k, s in enumerate(group):
            packed[s + 1] = packed[s] ^ masks[k]
            durations[s + 1] = durations[s]
            if flips <= thr:
                planted.append((s + 1, s))
            else:
                apart.append((s, s + 1))
    masks = _flip_masks(rng, 2 * edge, int(cfg["edge_radius"]), bits)
    for k, (i, j_in, j_out) in enumerate(edge_rows):
        packed[j_in] = packed[i] ^ masks[2 * k]
        packed[j_out] = packed[i] ^ masks[2 * k + 1]
        planted.append((j_in, i))
        apart.append((i, j_out))
    if not (np.diff(durations) >= 0).all():
        raise AssertionError("the planted rows broke the duration order")
    return Library(packed, durations, path_array(n), planted, apart)
