"""Duration-banded Hamming adjacency on the device: states, kernels, sweep.

Counterpart of the parts of ``vid_dup_finder_lib_tpu/ops/hamming_pallas.py``
on the search paths (``PallasSearchState``, ``_RefsState``,
``_launch_metadata``, ``_build_chunk_counts``, ``_build_chunk``,
``banded_adjacency_pallas``, ``refs_adjacency_pallas``).

A sweep compares the rows of one packed matrix with the columns of
another, each row with a contiguous window of columns:

* the self-search (:class:`SearchState`): rows and columns are the same
  duration-sorted library, and row i's window is ``i < j < bounds[i]``;
* the references search (:class:`RefsState`): rows are the
  duration-sorted references, columns the duration-sorted candidates, and
  ref i's window is ``row_lo[i] < j < bounds[i]`` (``lo[i] <= j < hi[i]``).

Rows and columns are cut into 128-hash tiles; row tile ``rt`` covers
column tiles ``first_ct[rt] .. first_ct[rt] + n_ct[rt] - 1`` (its "band
slots").  The sweep has two phases, as on the TPU:

* phase A, :func:`band_counts` -- one match count per (row tile, slot);
* phase B, :func:`band_pack` -- the bitpacked adjacency of the hit tiles
  only, transposed: word ``[h, r, c]`` holds rows ``32r .. 32r+31`` of
  column ``c`` of hit tile ``h``, bit ``b`` = row ``32r + b``.

Nonzero words are then decoded to ``(i, j)`` on the device with torch
ops.  A tensor on a CUDA device goes through the kernels of
``csrc/hamming_band.cu``; one on the CPU through the plain versions
(:func:`band_counts_plain`, :func:`band_pack_plain`), which unpack the
bits to +/-1 and take ``dot = 1024 - 2 * ham`` from a float matmul (exact:
every partial sum is an integer of magnitude <= 1024).
"""

from __future__ import annotations

import numpy as np
import torch

from ..definitions import HASH_BITS_PADDED, HASH_WORDS32
from ..utils import cuda_build

TILE = 128  # rows per row tile == columns per column tile (csrc TILE)
WORDS_PER_COL = TILE // 32  # packed words per column of a tile
ROW_LO_SENTINEL = 2**30  # row_lo of a pad row: no column lies above it


def launch_metadata(
    n: int, bounds: np.ndarray, n_row_tiles: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per row tile: first column tile of its band and the number of
    column tiles the band spans (``hamming_pallas._launch_metadata``).

    ``bounds`` must already be clamped to ``n``."""
    first_ct = np.zeros(n_row_tiles, dtype=np.int64)
    n_ct = np.zeros(n_row_tiles, dtype=np.int64)
    if n == 0:
        return first_ct, n_ct
    b = np.full(n_row_tiles * TILE, -1, dtype=np.int64)
    b[:n] = bounds[:n]
    cmax = b.reshape(n_row_tiles, TILE).max(axis=1)
    ct0 = (np.arange(n_row_tiles, dtype=np.int64) * TILE + 1) // TILE
    first_ct[:] = ct0
    n_ct[:] = np.maximum(0, -(-(cmax - ct0 * TILE) // TILE))
    return first_ct, n_ct


def refs_launch_metadata(
    row_lo: np.ndarray, bounds: np.ndarray, n_row_tiles: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per ref tile: first column tile and band width, from the real rows'
    windows ``row_lo < c < bounds`` (``_RefsState``, hamming_pallas.py
    :3299-3311).  A sorted ref list's tiles are not diagonal: ``first_ct``
    follows the smallest ``row_lo + 1`` of the tile, ``n_ct`` reaches its
    largest bound, and a tile of empty windows gets ``n_ct = 0``."""
    r = row_lo.shape[0]
    lo = np.full(n_row_tiles * TILE, ROW_LO_SENTINEL, dtype=np.int64)
    hi = np.full(n_row_tiles * TILE, -1, dtype=np.int64)
    lo[:r] = row_lo
    hi[:r] = bounds
    first_ct = (lo.reshape(n_row_tiles, TILE).min(axis=1) + 1) // TILE
    cmax = hi.reshape(n_row_tiles, TILE).max(axis=1)
    n_ct = np.maximum(0, -(-(cmax - first_ct * TILE) // TILE))
    return first_ct, n_ct


def _packed_rows(packed_u32: np.ndarray, what: str) -> np.ndarray:
    packed_u32 = np.ascontiguousarray(packed_u32, dtype=np.uint32)
    if packed_u32.ndim != 2 or packed_u32.shape[1] != HASH_WORDS32:
        raise ValueError(
            f"{what} must be uint32[n, {HASH_WORDS32}], got {packed_u32.shape}"
        )
    return packed_u32


def _tiled(packed_u32: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32[n, 32] -> int32[ceil(n / TILE) * TILE, 32] on ``device``,
    the words as int32 bit patterns, pad rows zero."""
    host = np.zeros((-(-packed_u32.shape[0] // TILE) * TILE, HASH_WORDS32), np.uint32)
    host[: packed_u32.shape[0]] = packed_u32
    return torch.from_numpy(host.view(np.int32)).to(device)


class SearchState:
    """The packed library resident on a device, with its band metadata.

    * ``packed``: int32[n_pad, 32], the hashes' uint32 words as int32 bit
      patterns (128 B/hash; pad rows are zero).  It is both the sweep's
      row matrix and its column matrix (``rows`` and ``cols``).
    * ``bounds``: int32[n_pad], each row's exclusive column bound clamped
      to n; pad rows carry -1 and match nothing.  ``row_lo`` is None: a
      row's window starts after its own index.
    * ``first_ct`` / ``n_ct``: per row tile, as host int64 arrays and as
      device int32 tensors (``*_dev``) for the kernels.
    * ``n``: the number of columns (the kernels' column clamp), here also
      the number of rows.
    """

    def __init__(
        self,
        packed_u32: np.ndarray,
        bounds: np.ndarray,
        device: torch.device,
    ) -> None:
        packed_u32 = _packed_rows(packed_u32, "packed")
        n = packed_u32.shape[0]
        bounds = np.asarray(bounds, dtype=np.int64)
        if bounds.shape != (n,):
            raise ValueError(f"bounds must be [{n}], got {bounds.shape}")
        if n >= 2**31 - TILE:
            raise ValueError(f"{n} hashes exceed the int32 index range")
        self.device = torch.device(device)
        self.n = n
        self.n_row_tiles = -(-n // TILE)
        self.n_pad = self.n_row_tiles * TILE
        clamped = np.minimum(bounds, n)
        self.first_ct, self.n_ct = launch_metadata(
            n, clamped, self.n_row_tiles
        )
        self.slots = int(self.n_ct.max()) if n else 0

        bounds_pad = np.full(self.n_pad, -1, dtype=np.int32)
        bounds_pad[:n] = clamped
        self.packed = _tiled(packed_u32, self.device)
        self.rows = self.cols = self.packed
        self.row_lo = None
        self.bounds = torch.from_numpy(bounds_pad).to(self.device)
        self.first_ct_dev = torch.from_numpy(
            self.first_ct.astype(np.int32)
        ).to(self.device)
        self.n_ct_dev = torch.from_numpy(self.n_ct.astype(np.int32)).to(
            self.device
        )

    def comparisons(self) -> int:
        """Pairs (i, j) inside the band, i < j < bounds[i]."""
        b = self.bounds[: self.n].to(torch.int64).cpu().numpy()
        return int(np.maximum(b - np.arange(1, self.n + 1), 0).sum())


class RefsState:
    """References against a candidate library, both resident on a device.

    * ``rows``: int32[r_pad, 32], the duration-sorted references, padded
      to 128-row tiles with zero rows; ``cols``: int32[n_pad, 32], the
      duration-sorted candidates, padded the same way.
    * ``row_lo`` = ``lo - 1`` and ``bounds`` = ``min(hi, n)``, int32[r_pad]
      (``hamming_pallas.py:3168-3171``): ref i's window is
      ``row_lo[i] < j < bounds[i]``.  Pad rows carry ``2^30`` and ``-1``.
    * ``first_ct`` / ``n_ct``: per ref tile, from
      :func:`refs_launch_metadata`, host and device (``*_dev``).
    * ``n``: the number of candidates (the kernels' column clamp);
      ``n_rows``: the number of references.
    """

    def __init__(
        self,
        refs_u32: np.ndarray,
        cands_u32: np.ndarray,
        lo: np.ndarray,
        hi: np.ndarray,
        device: torch.device,
    ) -> None:
        refs_u32 = _packed_rows(refs_u32, "refs_packed")
        cands_u32 = _packed_rows(cands_u32, "cands_packed")
        r, n = refs_u32.shape[0], cands_u32.shape[0]
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        if lo.shape != (r,) or hi.shape != (r,):
            raise ValueError(
                f"lo and hi must be [{r}], got {lo.shape} and {hi.shape}"
            )
        if max(r, n) >= ROW_LO_SENTINEL:
            raise ValueError(f"{max(r, n)} hashes exceed the index range")
        self.device = torch.device(device)
        self.n = n
        self.n_rows = r
        self.n_row_tiles = -(-r // TILE)
        r_pad = self.n_row_tiles * TILE
        row_lo = np.full(r_pad, ROW_LO_SENTINEL, dtype=np.int64)
        row_lo[:r] = np.clip(lo, 0, n) - 1
        bounds = np.full(r_pad, -1, dtype=np.int64)
        bounds[:r] = np.minimum(hi, n)
        self.first_ct, self.n_ct = refs_launch_metadata(
            row_lo[:r], bounds[:r], self.n_row_tiles
        )
        self.slots = int(self.n_ct.max()) if r and n else 0

        self.rows = _tiled(refs_u32, self.device)
        self.cols = _tiled(cands_u32, self.device)
        self.row_lo = torch.from_numpy(row_lo.astype(np.int32)).to(self.device)
        self.bounds = torch.from_numpy(bounds.astype(np.int32)).to(self.device)
        self.first_ct_dev = torch.from_numpy(
            self.first_ct.astype(np.int32)
        ).to(self.device)
        self.n_ct_dev = torch.from_numpy(self.n_ct.astype(np.int32)).to(
            self.device
        )

    def comparisons(self) -> int:
        """Pairs (i, j) inside the windows, lo[i] <= j < hi[i]."""
        lo = self.row_lo[: self.n_rows].to(torch.int64).cpu().numpy() + 1
        hi = self.bounds[: self.n_rows].to(torch.int64).cpu().numpy()
        return int(np.maximum(hi - lo, 0).sum())


SweepState = SearchState | RefsState  # what the sweep kernels take


# -- plain versions ----------------------------------------------------------


def pm1(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 32] packed words -> f32[..., 1024] over {-1, +1} (all
    1024 storage bits, bit b of word w at position 32w + b)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.unsqueeze(-1) >> shifts) & 1  # arithmetic shift, then & 1
    return (bits.to(torch.float32) * 2 - 1).flatten(-2)


def _thresh(tol: int) -> int:
    # ham <= tol  <=>  dot >= 1024 - 2 * tol
    return HASH_BITS_PADDED - 2 * int(tol)


def _window(state: SweepState, ridx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``ridx``' column windows ``lo < c < hi`` (any shape)."""
    lo = ridx if state.row_lo is None else state.row_lo[ridx]
    return lo, state.bounds[ridx]


def pack_words(adj: torch.Tensor) -> torch.Tensor:
    """bool[..., TILE/32, 32, TILE] (bit b of row group w) -> int32[...,
    TILE/32, TILE] words, bit b = row 32w + b."""
    shifts = torch.arange(32, device=adj.device, dtype=torch.int64)[:, None]
    w = (adj.to(torch.int64) << shifts).sum(-2)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def pm1_pair(state: SweepState) -> tuple[torch.Tensor, torch.Tensor]:
    """The state's row and column matrices over {-1, +1} (one tensor when
    they are the same matrix)."""
    rows = pm1(state.rows)
    return rows, rows if state.cols is state.rows else pm1(state.cols)


def row_tile_adjacency_plain(
    state: SweepState, pm_rows: torch.Tensor, pm_cols: torch.Tensor, rt: int, tol: int
) -> torch.Tensor:
    """bool[TILE rows, n_ct[rt] band slots, TILE columns]: the kernels'
    predicate for row tile ``rt`` against every column tile of its band."""
    nct = int(state.n_ct[rt])
    r0 = rt * TILE
    c0 = int(state.first_ct[rt]) * TILE
    c1 = c0 + nct * TILE
    dot = pm_rows[r0 : r0 + TILE] @ pm_cols[c0:c1].T  # [TILE, nct * TILE]
    lo, hi = _window(state, torch.arange(r0, r0 + TILE, device=state.device))
    cols = torch.arange(c0, c1, device=state.device)[None, :]
    adj = (dot >= _thresh(tol)) & (cols > lo[:, None]) & (cols < hi[:, None])
    return adj.view(TILE, nct, TILE)


def band_counts_plain(state: SweepState, tol: int) -> torch.Tensor:
    """Plain version of ``band_counts_kernel``: int32[row tiles, slots],
    for a :class:`SearchState` or a :class:`RefsState`."""
    counts = torch.zeros(
        (state.n_row_tiles, state.slots), dtype=torch.int32, device=state.device
    )
    if state.slots == 0:
        return counts
    pm_rows, pm_cols = pm1_pair(state)
    for rt in np.nonzero(state.n_ct)[0].tolist():
        adj = row_tile_adjacency_plain(state, pm_rows, pm_cols, rt, tol)
        counts[rt, : adj.shape[1]] = adj.sum(dim=(0, 2)).to(torch.int32)
    return counts


def band_pack_plain(
    state: SweepState, hits: torch.Tensor, tol: int, chunk: int = 256
) -> torch.Tensor:
    """Plain version of ``band_pack_kernel``: int32[H, TILE/32, TILE]."""
    dev = state.device
    n_hits = hits.shape[0]
    words = torch.empty(
        (n_hits, WORDS_PER_COL, TILE), dtype=torch.int32, device=dev
    )
    thresh = _thresh(tol)
    offs = torch.arange(TILE, device=dev)
    for h0 in range(0, n_hits, chunk):
        hc = hits[h0 : h0 + chunk].to(torch.int64)
        ridx = hc[:, :1] * TILE + offs  # [hc, TILE] row ids
        cidx = hc[:, 1:] * TILE + offs  # [hc, TILE] column ids
        dot = torch.bmm(
            pm1(state.rows[ridx]), pm1(state.cols[cidx]).transpose(1, 2)
        )  # [hc, TILE rows, TILE cols]
        lo, hi = _window(state, ridx)
        adj = (
            (dot >= thresh)
            & (cidx[:, None, :] > lo[:, :, None])
            & (cidx[:, None, :] < hi[:, :, None])
        )
        words[h0 : h0 + chunk] = pack_words(adj.view(-1, WORDS_PER_COL, 32, TILE))
    return words


# -- kernel wrappers ---------------------------------------------------------


def band_counts(state: SweepState, tol: int) -> torch.Tensor:
    """Phase A: match count per (row tile, band slot), int32[R, slots],
    for a :class:`SearchState` or a :class:`RefsState`.

    CUDA state -> ``band_counts_kernel`` (one launch over the whole band,
    on the current stream); CPU state -> :func:`band_counts_plain`."""
    if state.device.type == "cpu":
        return band_counts_plain(state, tol)
    counts = torch.empty(
        (state.n_row_tiles, state.slots), dtype=torch.int32,
        device=state.device,
    )
    if counts.numel() == 0:
        return counts
    if counts.numel() >= 2**31:
        raise ValueError(f"band grid of {counts.numel()} blocks exceeds 2^31")
    lib = cuda_build.load_library()
    err = lib.vdf_band_counts(
        cuda_build.ptr(state.rows, "rows"),
        cuda_build.ptr(state.cols, "cols"),
        cuda_build.ptr(state.bounds, "bounds"),
        _row_lo_ptr(state),
        cuda_build.ptr(state.first_ct_dev, "first_ct"),
        cuda_build.ptr(state.n_ct_dev, "n_ct"),
        cuda_build.ptr(counts, "counts"),
        state.n_row_tiles, state.slots, state.n, _clamp_tol(tol),
        cuda_build.current_stream(state.device),
    )
    cuda_build.check(err, "band_counts_kernel")
    band_counts.launches += 1
    return counts


def band_pack(state: SweepState, hits: torch.Tensor, tol: int) -> torch.Tensor:
    """Phase B: transposed bitpacked adjacency of the hit tiles
    (``hits``: int32[H, 2] of row tile, column tile) -> int32[H, 4, 128].

    CUDA state -> ``band_pack_kernel``; CPU state -> :func:`band_pack_plain`."""
    if state.device.type == "cpu":
        return band_pack_plain(state, hits, tol)
    if hits.dtype != torch.int32 or hits.ndim != 2 or hits.shape[1] != 2:
        raise ValueError(f"hits must be int32[H, 2], got {hits.dtype}{list(hits.shape)}")
    words = torch.empty(
        (hits.shape[0], WORDS_PER_COL, TILE), dtype=torch.int32,
        device=state.device,
    )
    if hits.shape[0] == 0:
        return words
    lib = cuda_build.load_library()
    err = lib.vdf_band_pack(
        cuda_build.ptr(state.rows, "rows"),
        cuda_build.ptr(state.cols, "cols"),
        cuda_build.ptr(state.bounds, "bounds"),
        _row_lo_ptr(state),
        cuda_build.ptr(hits, "hits"),
        cuda_build.ptr(words, "words"),
        hits.shape[0], state.n, _clamp_tol(tol),
        cuda_build.current_stream(state.device),
    )
    cuda_build.check(err, "band_pack_kernel")
    band_pack.launches += 1
    return words


band_counts.launches = 0  # kernel launches (CUDA path only)
band_pack.launches = 0


def _clamp_tol(tol: int) -> int:
    # any tolerance >= 1024 matches every pair; keep it in the C int range
    return min(int(tol), HASH_BITS_PADDED)


def _row_lo_ptr(state: SweepState) -> int | None:
    # NULL selects the self-search window c > r in the kernels
    return None if state.row_lo is None else cuda_build.ptr(state.row_lo, "row_lo")


# -- the two-phase sweep -----------------------------------------------------


def hit_tiles(state: SweepState, counts: torch.Tensor) -> torch.Tensor:
    """Phase A counts -> int32[H, 2] (row tile, column tile) of the tiles
    holding at least one match, in row-major order."""
    nz = torch.nonzero(counts)  # [H, 2]: row tile, band slot
    ct = state.first_ct_dev[nz[:, 0]].to(torch.int64) + nz[:, 1]
    return torch.stack([nz[:, 0], ct], dim=1).to(torch.int32).contiguous()


def decode_words(
    state: SweepState, hits: torch.Tensor, words: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transposed packed words of the hit tiles -> int64 (i, j) pairs,
    sorted lexicographically, on the state's device.  Pairs are keyed by
    ``i * n + j`` with ``n = state.n``, the number of columns."""
    flat = words.reshape(-1)
    loc = torch.nonzero(flat).squeeze(1)  # int64 word positions
    vals = flat[loc]
    per_hit = WORDS_PER_COL * TILE
    h = loc // per_hit
    r = (loc // TILE) % WORDS_PER_COL
    c = loc % TILE
    hits64 = hits.to(torch.int64)
    row_base = hits64[h, 0] * TILE + r * 32
    col = hits64[h, 1] * TILE + c
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    w_idx, b = torch.nonzero((vals[:, None] >> shifts) & 1, as_tuple=True)
    ii = row_base[w_idx] + b
    jj = col[w_idx]
    key = torch.sort(ii * state.n + jj).values  # int64: rows * n < 2^62
    return key // state.n, key % state.n


def _two_phase(state, tol, counts_fn, pack_fn) -> tuple[np.ndarray, np.ndarray]:
    if state.slots == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    hits = hit_tiles(state, counts_fn(state, tol))
    words = pack_fn(state, hits, tol)
    ii, jj = decode_words(state, hits, words)
    return ii.cpu().numpy(), jj.cpu().numpy()


def banded_adjacency_cuda(
    state: SearchState, tol: int
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), i < j < bounds[i], with hamming <= tol, as int64
    NumPy arrays in lexicographic order (the contract of
    ``hamming_pallas.banded_adjacency_pallas``).

    The kernels run for a CUDA state, their plain versions for a CPU one."""
    return _two_phase(state, tol, band_counts, band_pack)


def banded_adjacency_plain(
    state: SearchState, tol: int
) -> tuple[np.ndarray, np.ndarray]:
    """The same sweep over the plain versions, on any device (the
    reference the kernels are held to on the card)."""
    return _two_phase(state, tol, band_counts_plain, band_pack_plain)


def refs_adjacency_cuda(
    state: RefsState, tol: int
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), lo[i] <= j < hi[i], with hamming <= tol, as int64
    NumPy arrays in lexicographic order, i in ref space (the contract of
    ``hamming_pallas.refs_adjacency_pallas``).

    The kernels run in their window mode for a CUDA state, their plain
    versions for a CPU one."""
    return _two_phase(state, tol, band_counts, band_pack)


def refs_adjacency_plain(
    state: RefsState, tol: int
) -> tuple[np.ndarray, np.ndarray]:
    """The references sweep over the plain versions, on any device."""
    return _two_phase(state, tol, band_counts_plain, band_pack_plain)
