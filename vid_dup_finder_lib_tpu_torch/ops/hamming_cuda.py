"""Duration-banded Hamming adjacency on the device: states, kernels, sweep.

Counterpart of the parts of ``vid_dup_finder_lib_tpu/ops/hamming_pallas.py``
on the search paths (``PallasSearchState``, ``_RefsState``,
``IncrementalDeviceLibrary``, ``_launch_metadata``, ``_build_chunk_counts``,
``_build_chunk``, ``banded_adjacency_pallas``, ``refs_adjacency_pallas``).
A state's matrices are uploaded from the host, or taken from rows already
resident on the device (:class:`IncrementalDeviceLibrary`).

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
ops.  The sweep walks consecutive slabs of row tiles (:func:`count_slabs`),
each with counts of its own that fit ``COUNTS_BUDGET`` cells, so its
scratch is bounded by that budget and by the pairs found: the dense counts
of a whole library grow with its square (23 MB at 1M hashes of
chip_smoke.py's recipe, 1.4 GB at 8M, 23 GB at 32M).  This is the port's
counterpart of the JAX package's windowed and split states
(``WindowedPallasState``, ``SplitWindowState``, ``ChunkedPackedStore``,
``WindowedRefsState``), which slide a window over the TPU kernels' 1 KB/hash
int8 operand; the kernels here read the packed rows, 128 B/hash.  A tensor on a CUDA device goes through the kernels of
``csrc/hamming_band.cu`` (both on the int8 tensor cores); one on the CPU through the plain versions
(:func:`band_counts_plain`, :func:`band_pack_plain`), which unpack the
bits to +/-1 and take ``dot = 1024 - 2 * ham`` from a float matmul (exact:
every partial sum is an integer of magnitude <= 1024).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..definitions import HASH_BITS_PADDED, HASH_WORDS32
from ..utils import cuda_build, staging
from ..utils.device import resolve_device
from ..utils.timers import count, span

TILE = 128  # rows per row tile == columns per column tile (csrc TILE)
WORDS_PER_COL = TILE // 32  # packed words per column of a tile
ROW_LO_SENTINEL = 2**30  # row_lo of a pad row: no column lies above it
PACK_CHUNK_MAX = 32  # most hit tiles one block of band_pack_kernel walks
COUNTS_BUDGET = 1 << 26  # most int32 count cells of one slab: 256 MiB
PLAIN_SPAN = 1 << 18  # columns band_counts_plain unpacks beyond one band: 1 GiB of f32


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


def _host_rows_bytes(packed: np.ndarray | torch.Tensor, n: int) -> int:
    """The bytes a state uploads of ``n`` packed rows: none of a resident
    tensor."""
    return 0 if isinstance(packed, torch.Tensor) else n * HASH_WORDS32 * 4


def _packed_rows(packed_u32: np.ndarray, what: str) -> np.ndarray:
    packed_u32 = np.ascontiguousarray(packed_u32, dtype=np.uint32)
    if packed_u32.ndim != 2 or packed_u32.shape[1] != HASH_WORDS32:
        raise ValueError(
            f"{what} must be uint32[n, {HASH_WORDS32}], got {packed_u32.shape}"
        )
    return packed_u32


def _tiled(packed_u32: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32[n, 32] -> int32[ceil(n / TILE) * TILE, 32] on ``device``,
    the words as int32 bit patterns, pad rows zero.  On a CUDA device the
    pad rows are zeroed there and the rows go up through the pinned
    staging buffer (:mod:`..utils.staging`)."""
    n = packed_u32.shape[0]
    n_pad = -(-n // TILE) * TILE
    if device.type == "cuda":
        out = torch.empty((n_pad, HASH_WORDS32), dtype=torch.int32, device=device)
        out[n:].zero_()
        staging.upload_into(out[:n], packed_u32.view(np.int32))
        return out
    host = np.zeros((n_pad, HASH_WORDS32), np.uint32)
    host[:n] = packed_u32
    return torch.from_numpy(host.view(np.int32)).to(device)


def _matrix(
    packed: np.ndarray | torch.Tensor, n: int | None, device: torch.device,
    what: str,
) -> tuple[torch.Tensor, int]:
    """A sweep operand and its row count: a host uint32[n, 32] matrix is
    tiled and uploaded; a resident int32[>= n_pad, 32] tensor on ``device``
    (``n`` rows, then anything) becomes its first n_pad rows, a view that
    shares its storage.  Rows in [n, n_pad) of a resident tensor may hold
    anything: the kernels and plain versions never match a column at or
    past ``n``, and pad rows carry no window."""
    if not isinstance(packed, torch.Tensor):
        packed = _packed_rows(packed, what)
        return _tiled(packed, device), packed.shape[0]
    if n is None:
        raise ValueError(f"{what}: a resident tensor needs its row count n")
    n_pad = -(-n // TILE) * TILE
    if (
        packed.dtype != torch.int32 or packed.ndim != 2
        or packed.shape[1] != HASH_WORDS32 or packed.shape[0] < n_pad
    ):
        raise ValueError(
            f"{what} must be int32[>= {n_pad}, {HASH_WORDS32}], got"
            f" {packed.dtype}{list(packed.shape)}"
        )
    if packed.device != device:
        raise ValueError(f"{what} lies on {packed.device}, the state on {device}")
    if not packed.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return packed[:n_pad], n


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

    ``packed`` is a host uint32[n, 32] matrix (tiled and uploaded) or a
    resident int32[>= n_pad, 32] tensor on ``device`` holding ``n`` rows
    first (:class:`IncrementalDeviceLibrary`), of which the state keeps a
    view.
    """

    def __init__(
        self,
        packed: np.ndarray | torch.Tensor,
        bounds: np.ndarray,
        device: torch.device,
        n: int | None = None,
    ) -> None:
        with span("sweep.state"):
            self.device = torch.device(device)
            self.packed, n = _matrix(packed, n, self.device, "packed")
            bounds = np.asarray(bounds, dtype=np.int64)
            if bounds.shape != (n,):
                raise ValueError(f"bounds must be [{n}], got {bounds.shape}")
            if n >= 2**31 - TILE:
                raise ValueError(f"{n} hashes exceed the int32 index range")
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
            self.rows = self.cols = self.packed
            self.row_lo = None
            self.bounds = torch.from_numpy(bounds_pad).to(self.device)
            self.first_ct_dev = torch.from_numpy(
                self.first_ct.astype(np.int32)
            ).to(self.device)
            self.n_ct_dev = torch.from_numpy(self.n_ct.astype(np.int32)).to(
                self.device
            )
            count(h2d_bytes=_host_rows_bytes(packed, n) + 4 * (self.n_pad + 2 * self.n_row_tiles))

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

    ``cands`` is a host uint32[n, 32] matrix or a resident int32[>= n_pad,
    32] tensor on ``device`` with ``n_cands`` rows first (then only the
    references travel host to device); ``refs`` likewise, with ``n_refs``
    rows (the ring's steps sweep one resident block against another).
    """

    def __init__(
        self,
        refs: np.ndarray | torch.Tensor,
        cands: np.ndarray | torch.Tensor,
        lo: np.ndarray,
        hi: np.ndarray,
        device: torch.device,
        n_cands: int | None = None,
        n_refs: int | None = None,
    ) -> None:
        with span("sweep.state"):
            self.device = torch.device(device)
            self.rows, r = _matrix(refs, n_refs, self.device, "refs_packed")
            self.cols, n = _matrix(cands, n_cands, self.device, "cands_packed")
            lo = np.asarray(lo, dtype=np.int64)
            hi = np.asarray(hi, dtype=np.int64)
            if lo.shape != (r,) or hi.shape != (r,):
                raise ValueError(
                    f"lo and hi must be [{r}], got {lo.shape} and {hi.shape}"
                )
            if max(r, n) >= ROW_LO_SENTINEL:
                raise ValueError(f"{max(r, n)} hashes exceed the index range")
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

            self.row_lo = torch.from_numpy(row_lo.astype(np.int32)).to(self.device)
            self.bounds = torch.from_numpy(bounds.astype(np.int32)).to(self.device)
            self.first_ct_dev = torch.from_numpy(
                self.first_ct.astype(np.int32)
            ).to(self.device)
            self.n_ct_dev = torch.from_numpy(self.n_ct.astype(np.int32)).to(
                self.device
            )
            count(h2d_bytes=_host_rows_bytes(refs, r) + _host_rows_bytes(cands, n)
                  + 4 * (2 * r_pad + 2 * self.n_row_tiles))

    def comparisons(self) -> int:
        """Pairs (i, j) inside the windows, lo[i] <= j < hi[i]."""
        lo = self.row_lo[: self.n_rows].to(torch.int64).cpu().numpy() + 1
        hi = self.bounds[: self.n_rows].to(torch.int64).cpu().numpy()
        return int(np.maximum(hi - lo, 0).sum())


SweepState = SearchState | RefsState  # what the sweep kernels take


class IncrementalDeviceLibrary:
    """Append-only packed-hash store resident on one device (counterpart
    of ``hamming_pallas.IncrementalDeviceLibrary``, without its chunked
    store).

    ``packed`` is an int32[capacity, 32] tensor on ``device`` whose first
    ``n`` rows are the appended hashes in insertion order; the rest are
    zero until appended.  :meth:`append` uploads only the new rows, into
    the buffer in place.  The capacity is a multiple of the 128-row tile
    and doubles when an append needs more: growth allocates the new
    buffer and copies the old rows across, so for that moment the device
    holds both, three times the old buffer's bytes.  On a CUDA device a
    growth that the free memory cannot hold raises a ``ValueError`` naming
    the rows and the bytes (the counterpart of the JAX package's
    ``check_packed_capacity``), before anything is allocated.

    :meth:`state` hands the rows to a :class:`SearchState` in a
    duration-sorted order: zero-copy (a view of ``packed``) when the order
    is the identity over all ``n`` rows, otherwise through one
    ``index_select`` gather.  A later :meth:`append` may write rows past a
    zero-copy state's ``n`` into the storage it shares; the sweeps never
    read a column at or past their state's ``n``, so the state stays
    correct.
    """

    def __init__(
        self, device: torch.device | str | None = None, capacity: int = 4096
    ) -> None:
        self.device = resolve_device(device)
        cap = -(-max(TILE, int(capacity)) // TILE) * TILE
        self.packed = torch.zeros((cap, HASH_WORDS32), dtype=torch.int32, device=self.device)
        self.n = 0

    @property
    def capacity(self) -> int:
        return self.packed.shape[0]

    def append(self, packed_rows: np.ndarray) -> None:
        """Append uint32[k, 32] rows.  The rows are copied: a later change
        to the caller's array does not reach the library."""
        rows = _packed_rows(packed_rows, "packed_rows")
        k = rows.shape[0]
        if k == 0:
            return
        if self.n + k > self.capacity:
            self._grow(self.n + k)
        if not rows.flags.writeable:  # torch.from_numpy takes writable arrays only
            rows = rows.copy()
        self.packed[self.n : self.n + k].copy_(torch.from_numpy(rows.view(np.int32)))
        self.n += k

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        if self.device.type == "cuda":
            # the old buffer stays until the copy is done: the new one must
            # fit beside it (torch's cached free blocks count as free)
            need_bytes = cap * HASH_WORDS32 * 4
            free = torch.cuda.mem_get_info(self.device)[0] + (
                torch.cuda.memory_reserved(self.device)
                - torch.cuda.memory_allocated(self.device)
            )
            if need_bytes > free:
                raise ValueError(
                    f"the device library cannot grow to {need} rows: its new"
                    f" buffer of {cap} rows needs {need_bytes} bytes beside"
                    f" the old one's {self.capacity * HASH_WORDS32 * 4}, and"
                    f" {self.device} has {free} bytes free"
                )
        grown = torch.zeros((cap, HASH_WORDS32), dtype=torch.int32, device=self.device)
        grown[: self.n].copy_(self.packed[: self.n])
        self.packed = grown

    def sorted_rows(self, order: np.ndarray) -> torch.Tensor:
        """Rows ``order`` (insertion index per sorted position) as an
        int32[>= n_pad, 32] tensor, ``len(order)`` rows first: ``packed``
        itself when ``order`` is the identity over all ``n`` rows and the
        capacity covers n_pad, else a gather whose pad rows repeat row 0."""
        order = np.asarray(order, dtype=np.int64)
        if order.ndim != 1:
            raise ValueError(f"order must be 1-D, got shape {order.shape}")
        n = order.shape[0]
        n_pad = -(-n // TILE) * TILE
        if n and (int(order.min()) < 0 or int(order.max()) >= self.n):
            raise ValueError(
                f"order holds rows outside the library's {self.n}"
                f" ([{int(order.min())}, {int(order.max())}])"
            )
        if n == self.n and self.capacity >= n_pad and np.array_equal(
            order, np.arange(n)
        ):
            return self.packed
        idx = np.zeros(n_pad, dtype=np.int64)
        idx[:n] = order
        return self.packed.index_select(0, torch.from_numpy(idx).to(self.device))

    def state(self, order: np.ndarray, bounds: np.ndarray) -> SearchState:
        """Duration-sorted search state over rows ``order`` with the
        sorted rows' exclusive column ``bounds`` (:meth:`sorted_rows`)."""
        return SearchState(self.sorted_rows(order), bounds, self.device, n=len(order))

    def take_rows(self, idx) -> np.ndarray:
        """uint32[len(idx), 32]: a few rows, fetched to the host."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= self.n):
            raise ValueError(f"rows {idx.tolist()} outside the library's {self.n}")
        rows = self.packed.index_select(0, torch.from_numpy(idx).to(self.device))
        return rows.cpu().numpy().view(np.uint32)


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
    predicate for row tile ``rt`` against every column tile of its band,
    from the whole matrices over {-1, +1} (:func:`pm1_pair`)."""
    r0 = rt * TILE
    c0 = int(state.first_ct[rt]) * TILE
    c1 = c0 + int(state.n_ct[rt]) * TILE
    return _adjacency_plain(state, pm_rows[r0 : r0 + TILE], pm_cols[c0:c1], r0, c0, tol)


def _adjacency_plain(
    state: SweepState, pm_r: torch.Tensor, pm_c: torch.Tensor, r0: int, c0: int, tol: int
) -> torch.Tensor:
    """The predicate for rows ``r0 ..`` (``pm_r``, one tile) against the
    columns ``c0 ..`` (``pm_c``, whole tiles): bool[TILE, tiles, TILE]."""
    dot = pm_r @ pm_c.T  # [TILE, tiles * TILE]
    lo, hi = _window(state, torch.arange(r0, r0 + TILE, device=state.device))
    cols = torch.arange(c0, c0 + pm_c.shape[0], device=state.device)[None, :]
    adj = (dot >= _thresh(tol)) & (cols > lo[:, None]) & (cols < hi[:, None])
    return adj.view(TILE, -1, TILE)


def _slab(state: SweepState, rt0: int, rt1: int | None) -> tuple[int, int]:
    """``(rt1, slots)`` of the slab of row tiles ``[rt0, rt1)`` (``rt1``
    None: to the last): its end, checked, and its widest band."""
    rt1 = state.n_row_tiles if rt1 is None else rt1
    if not 0 <= rt0 <= rt1 <= state.n_row_tiles:
        raise ValueError(
            f"row tiles [{rt0}, {rt1}) outside [0, {state.n_row_tiles})"
        )
    return rt1, int(state.n_ct[rt0:rt1].max(initial=0))


def band_counts_plain(
    state: SweepState, tol: int, rt0: int = 0, rt1: int | None = None
) -> torch.Tensor:
    """Plain version of ``band_counts_kernel``: int32[rt1 - rt0, slots]
    over the row tiles ``[rt0, rt1)`` (default: all), ``slots`` that
    slab's widest band, for a :class:`SearchState` or a :class:`RefsState`.
    It unpacks a span of columns at a time, never the whole library."""
    rt1, slots = _slab(state, rt0, rt1)
    counts = torch.zeros((rt1 - rt0, slots), dtype=torch.int32, device=state.device)
    s0 = s1 = 0  # the span of columns unpacked in pm_cols
    pm_cols = None
    for rt in (rt0 + np.nonzero(state.n_ct[rt0:rt1])[0]).tolist():
        r0, c0 = rt * TILE, int(state.first_ct[rt]) * TILE
        c1 = c0 + int(state.n_ct[rt]) * TILE
        if not s0 <= c0 <= c1 <= s1:
            # the band and PLAIN_SPAN more: the next row tiles' bands too
            s0, s1 = c0, c1 + PLAIN_SPAN
            pm_cols = pm1(state.cols[s0:s1])
        adj = _adjacency_plain(
            state, pm1(state.rows[r0 : r0 + TILE]), pm_cols[c0 - s0 : c1 - s0], r0, c0, tol
        )
        counts[rt - rt0, : adj.shape[1]] = adj.sum(dim=(0, 2)).to(torch.int32)
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


def band_counts(
    state: SweepState, tol: int, rt0: int = 0, rt1: int | None = None
) -> torch.Tensor:
    """Phase A: match count per (row tile, band slot) of the row tiles
    ``[rt0, rt1)`` (default: all), int32[rt1 - rt0, slots] with ``slots``
    that slab's widest band (``state.slots`` for the whole state), for a
    :class:`SearchState` or a :class:`RefsState`.

    CUDA state -> ``band_counts_kernel`` (one launch on the current
    stream); CPU state -> :func:`band_counts_plain`."""
    if state.device.type == "cpu":
        return band_counts_plain(state, tol, rt0, rt1)
    rt1, slots = _slab(state, rt0, rt1)
    counts = torch.zeros((rt1 - rt0, slots), dtype=torch.int32, device=state.device)
    if counts.numel() == 0:
        return counts
    lib = cuda_build.load_library()
    with torch.cuda.device(state.device):
        err = lib.vdf_band_counts(
            cuda_build.ptr(state.rows, "rows"),
            cuda_build.ptr(state.cols, "cols"),
            cuda_build.ptr(state.bounds, "bounds"),
            _row_lo_ptr(state),
            cuda_build.ptr(state.first_ct_dev, "first_ct"),
            cuda_build.ptr(state.n_ct_dev, "n_ct"),
            cuda_build.ptr(counts, "counts"),
            rt1 - rt0, rt0, slots, state.n, _clamp_tol(tol),
            cuda_build.current_stream(state.device),
        )
    cuda_build.check(err, "band_counts_kernel")
    with _LAUNCHES_LOCK:  # the ring's shards on distinct cards launch from threads
        band_counts.launches += 1
    return counts


def pack_chunk(n_hits: int, n_sms: int) -> int:
    """Hit tiles per block of ``band_pack_kernel``: the list is cut into
    chunks of consecutive hits, one block each.  A block expands a row
    tile once for a run of hits that share it, so long chunks serve a
    row-major list with many hits per row tile, while few hits must still
    spread over all ``n_sms`` multiprocessors: ``ceil(H / n_sms)``, at
    least 1 and at most ``PACK_CHUNK_MAX``."""
    return max(1, min(PACK_CHUNK_MAX, -(-int(n_hits) // max(1, int(n_sms)))))


def band_pack(state: SweepState, hits: torch.Tensor, tol: int) -> torch.Tensor:
    """Phase B: transposed bitpacked adjacency of the hit tiles
    (``hits``: int32[H, 2] of row tile, column tile) -> int32[H, 4, 128].
    Any tile of the state may be listed, in any order; one without a match
    gets zero words.

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
    with torch.cuda.device(state.device):
        err = lib.vdf_band_pack(
            cuda_build.ptr(state.rows, "rows"),
            cuda_build.ptr(state.cols, "cols"),
            cuda_build.ptr(state.bounds, "bounds"),
            _row_lo_ptr(state),
            cuda_build.ptr(hits, "hits"),
            cuda_build.ptr(words, "words"),
            hits.shape[0],
            pack_chunk(
                hits.shape[0],
                torch.cuda.get_device_properties(state.device).multi_processor_count,
            ),
            state.n, _clamp_tol(tol),
            cuda_build.current_stream(state.device),
        )
    cuda_build.check(err, "band_pack_kernel")
    with _LAUNCHES_LOCK:  # the ring's shards on distinct cards launch from threads
        band_pack.launches += 1
    return words


_LAUNCHES_LOCK = threading.Lock()
band_counts.launches = 0  # kernel launches (CUDA path only)
band_pack.launches = 0


def _clamp_tol(tol: int) -> int:
    # any tolerance >= 1024 matches every pair and any negative one none;
    # [-1, 1024] keeps it, and K2's threshold 1024 - 2 * tol, in the C int range
    return max(-1, min(int(tol), HASH_BITS_PADDED))


def _row_lo_ptr(state: SweepState) -> int | None:
    # NULL selects the self-search window c > r in the kernels
    return None if state.row_lo is None else cuda_build.ptr(state.row_lo, "row_lo")


# -- the two-phase sweep -----------------------------------------------------


def hit_tiles(state: SweepState, counts: torch.Tensor, rt0: int = 0) -> torch.Tensor:
    """Phase A counts of the row tiles from ``rt0`` on -> int32[H, 2] (row
    tile, column tile, both of the whole state) of the tiles holding at
    least one match, in row-major order."""
    with span("sweep.wait", what="hits"):
        nz = torch.nonzero(counts)  # [H, 2]: row tile of the slab, band slot
    rt = nz[:, 0] + rt0
    ct = state.first_ct_dev[rt].to(torch.int64) + nz[:, 1]
    return torch.stack([rt, ct], dim=1).to(torch.int32).contiguous()


def decode_words(
    state: SweepState, hits: torch.Tensor, words: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transposed packed words of the hit tiles -> int64 (i, j) pairs,
    sorted lexicographically, on the state's device.  Pairs are keyed by
    ``i * n + j`` with ``n = state.n``, the number of columns."""
    flat = words.reshape(-1)
    with span("sweep.wait", what="decode"):
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
    with span("sweep.wait", what="decode"):
        w_idx, b = torch.nonzero((vals[:, None] >> shifts) & 1, as_tuple=True)
    ii = row_base[w_idx] + b
    jj = col[w_idx]
    key = torch.sort(ii * state.n + jj).values  # int64: rows * n < 2^62
    return key // state.n, key % state.n


def count_slabs(
    state: SweepState, budget: int | None = None
) -> list[tuple[int, int]]:
    """Consecutive row-tile slabs ``[rt0, rt1)`` covering the state, each
    as long as its counts -- row tiles times the slab's widest band -- fit
    ``budget`` int32 cells (default ``COUNTS_BUDGET``), or a single row
    tile.  A state whose whole counts fit is one slab."""
    budget = COUNTS_BUDGET if budget is None else int(budget)
    n_ct = state.n_ct.tolist()
    out, rt0, widest = [], 0, 0
    for rt, nct in enumerate(n_ct):
        widest = max(widest, nct)
        if rt > rt0 and (rt + 1 - rt0) * widest > budget:
            out.append((rt0, rt))
            rt0, widest = rt, nct
    if n_ct:
        out.append((rt0, len(n_ct)))
    return out


def _two_phase(
    state, tol, counts_fn, pack_fn, counts_budget=None
) -> tuple[np.ndarray, np.ndarray]:
    """Phase A, hit list, phase B and decode, slab by slab: a slab's counts,
    hits and words are released before the next slab's are allocated."""
    pairs = []
    for rt0, rt1 in count_slabs(state, counts_budget):
        if not state.n_ct[rt0:rt1].any():
            continue
        with span("sweep.slab", row_tiles=rt1 - rt0):
            hits = hit_tiles(state, counts_fn(state, tol, rt0, rt1), rt0)
            count(hit_tiles=hits.shape[0])
            if hits.shape[0]:
                pairs.append(decode_words(state, hits, pack_fn(state, hits, tol)))
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    # slabs ascend in rows, so their sorted pairs concatenate sorted
    with span("sweep.wait", what="fetch"):
        ii, jj = (torch.cat(p).cpu().numpy() for p in zip(*pairs))
    return ii, jj


def banded_adjacency_cuda(
    state: SearchState, tol: int, counts_budget: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), i < j < bounds[i], with hamming <= tol, as int64
    NumPy arrays in lexicographic order (the contract of
    ``hamming_pallas.banded_adjacency_pallas``), swept in slabs of at most
    ``counts_budget`` count cells (:func:`count_slabs`).

    The kernels run for a CUDA state, their plain versions for a CPU one."""
    return _two_phase(state, tol, band_counts, band_pack, counts_budget)


def banded_adjacency_plain(
    state: SearchState, tol: int, counts_budget: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The same sweep over the plain versions, on any device (the
    reference the kernels are held to on the card)."""
    return _two_phase(state, tol, band_counts_plain, band_pack_plain, counts_budget)


def refs_adjacency_cuda(
    state: RefsState, tol: int, counts_budget: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), lo[i] <= j < hi[i], with hamming <= tol, as int64
    NumPy arrays in lexicographic order, i in ref space (the contract of
    ``hamming_pallas.refs_adjacency_pallas``), swept in slabs of ref tiles
    like :func:`banded_adjacency_cuda`.

    The kernels run in their window mode for a CUDA state, their plain
    versions for a CPU one."""
    return _two_phase(state, tol, band_counts, band_pack, counts_budget)


def refs_adjacency_plain(
    state: RefsState, tol: int, counts_budget: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The references sweep over the plain versions, on any device."""
    return _two_phase(state, tol, band_counts_plain, band_pack_plain, counts_budget)
