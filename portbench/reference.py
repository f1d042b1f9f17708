"""The plain reference of the self-search: which groups ``search()`` has
to return for a library, worked out again from the hashes, the durations
and the paths alone.

It follows the upstream crate's greedy search
(``vid_dup_finder_lib/src/video_hashing/search_algorithm.rs``): entries
in (duration, bytewise path) order; each entry not yet matched takes, in
order, every unmatched later entry whose duration is at most
``int(d * 1.1)`` and whose Hamming distance is at most
``int(tolerance * 1000)``; a target with such candidates makes one group,
the candidates then the target; the groups come out in reverse.

The distances come from one matrix product of the hashes as +1/-1
vectors: over ``bits`` positions, ``dot = bits - 2 * hamming``.  The
products are small integers (at most 1000 in size), exact in float16 and
float32 whatever the order of the sums, so a plain ``torch.matmul`` gives
them exactly.  Rows go in blocks, and each block's candidates, the
columns up to its last row's window end, in chunks, so any library fits.

It imports numpy and torch only: nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 8192
CHUNK_COLS = 131072  # at least BLOCK_ROWS: only a block's first chunk holds its own rows
EXPAND_ROWS = 1 << 20


def sign_matrix(packed: np.ndarray, bits: int, device, dtype) -> torch.Tensor:
    """The first ``bits`` bits of each hash (word ``w``'s bit ``b`` is bit
    ``32 w + b``) as a ``[n, bits]`` matrix of +1 / -1."""
    n = packed.shape[0]
    words = torch.from_numpy(packed.view(np.int32)).to(device)
    shifts = torch.arange(32, device=device, dtype=torch.int32)
    out = torch.empty((n, bits), dtype=dtype, device=device)
    for r0 in range(0, n, EXPAND_ROWS):
        w = words[r0 : r0 + EXPAND_ROWS]
        b = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], 32 * w.shape[1])[:, :bits]
        out[r0 : r0 + w.shape[0]] = (b * 2 - 1).to(dtype)
    return out


def adjacency(
    packed: np.ndarray,
    bounds: np.ndarray,
    max_distance: int,
    bits: int = 1000,
    device="cpu",
) -> tuple[np.ndarray, np.ndarray]:
    """Every pair ``i < j < bounds[i]`` of a duration-sorted library whose
    Hamming distance over the first ``bits`` bits is at most
    ``max_distance``, as int64 arrays sorted by (i, j).

    A first pass keeps only each chunk's largest product (the pairs
    ``j <= i`` of a block's own rows masked out), with no wait for the
    device; a second computes again the few chunks that hold a pair and
    lists it."""
    device = torch.device(device)
    dtype = torch.float16 if device.type == "cuda" else torch.float32
    n = packed.shape[0]
    signs = sign_matrix(packed, bits, device, dtype)
    min_dot = bits - 2 * max_distance
    below = torch.ones((BLOCK_ROWS, BLOCK_ROWS), dtype=torch.bool, device=device).tril()

    def products(r0, r1, c0, c1):
        dot = signs[r0:r1] @ signs[c0:c1].T
        if c0 < r1:  # the block's own rows: only j > i counts
            own = min(r1, c1) - c0
            dot[:, :own].masked_fill_(below[: r1 - r0, :own], float("-inf"))
        return dot

    chunks, peaks = [], []
    for r0 in range(0, n, BLOCK_ROWS):
        r1 = min(r0 + BLOCK_ROWS, n)
        for c0 in range(r0, int(bounds[r0:r1].max()), CHUNK_COLS):
            c1 = min(c0 + CHUNK_COLS, int(bounds[r0:r1].max()))
            chunks.append((r0, r1, c0, c1))
            peaks.append(products(r0, r1, c0, c1).amax())
    found_i, found_j = [], []
    if peaks:
        hot = (torch.stack(peaks) >= min_dot).cpu().numpy()
        bounds_t = torch.from_numpy(np.asarray(bounds, np.int64)).to(device)
        for k in np.flatnonzero(hot).tolist():
            r0, r1, c0, c1 = chunks[k]
            hit = torch.nonzero(products(r0, r1, c0, c1) >= min_dot)
            i, j = hit[:, 0] + r0, hit[:, 1] + c0
            keep = j < bounds_t[i]
            found_i.append(i[keep].cpu())
            found_j.append(j[keep].cpu())
    del signs
    if not found_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = torch.cat(found_i).numpy()
    jj = torch.cat(found_j).numpy()
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]


def sort_order(durations: np.ndarray, paths_bytes: np.ndarray) -> np.ndarray | None:
    """The (duration, bytewise path) order of the entries, or None when
    they are in it already."""
    d, p = durations, paths_bytes
    if ((d[1:] > d[:-1]) | ((d[1:] == d[:-1]) & (p[1:] >= p[:-1]))).all():
        return None
    return np.lexsort((p, d))


def greedy_groups(n: int, ii: np.ndarray, jj: np.ndarray) -> list[list[int]]:
    """The crate's greedy consume over the in-tolerance pairs (sorted by
    (i, j)) of ``n`` sorted entries: groups of entry indices, candidates
    then target, in the crate's (reversed) order."""
    matched = np.zeros(n, bool)
    starts = np.searchsorted(ii, np.arange(n + 1))
    groups = []
    for lhs in np.unique(ii).tolist():
        if matched[lhs]:
            continue
        matched[lhs] = True
        cands = jj[starts[lhs] : starts[lhs + 1]]
        take = cands[~matched[cands]]
        if take.size:
            matched[take] = True
            groups.append(take.tolist() + [lhs])
    groups.reverse()
    return groups


def self_search_groups(
    packed: np.ndarray,
    durations: np.ndarray,
    paths_bytes: np.ndarray,
    tolerance: float,
    window_factor: float = 1.1,
    hash_bits: int = 1000,
    bits: int | None = None,
    device="cpu",
) -> list[tuple[str, ...]]:
    """The groups of paths a self-search of these hashes returns.
    ``bits`` reads the distance over fewer bits than ``hash_bits`` (the
    control, which breaks the exact-distance guarantee)."""
    order = sort_order(durations, paths_bytes)
    if order is not None:
        packed, durations, paths_bytes = packed[order], durations[order], paths_bytes[order]
    ends = (durations.astype(np.float64) * window_factor).astype(np.int64)
    bounds = np.searchsorted(durations, ends, side="right")
    max_distance = max(0, int(tolerance * hash_bits))
    ii, jj = adjacency(packed, bounds, max_distance, bits or hash_bits, device)
    return [tuple(p.decode() for p in paths_bytes[g].tolist())
            for g in greedy_groups(len(durations), ii, jj)]
