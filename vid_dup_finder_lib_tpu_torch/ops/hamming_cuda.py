"""Duration-banded Hamming adjacency on the device: state, kernels, sweep.

Counterpart of the parts of ``vid_dup_finder_lib_tpu/ops/hamming_pallas.py``
on the search path (``PallasSearchState``, ``_launch_metadata``,
``_build_chunk_counts``, ``_build_chunk``, ``banded_adjacency_pallas``).

The library is duration-sorted, so row i's candidates are the contiguous
columns ``i < j < bounds[i]``.  Rows and columns are cut into 128-hash
tiles; row tile ``rt`` covers column tiles ``first_ct[rt] ..
first_ct[rt] + n_ct[rt] - 1`` (its "band slots").  The sweep has two
phases, as on the TPU:

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


class SearchState:
    """The packed library resident on a device, with its band metadata.

    * ``packed``: int32[n_pad, 32], the hashes' uint32 words as int32 bit
      patterns (128 B/hash; pad rows are zero).
    * ``bounds``: int32[n_pad], each row's exclusive column bound clamped
      to n; pad rows carry -1 and match nothing.
    * ``first_ct`` / ``n_ct``: per row tile, as host int64 arrays and as
      device int32 tensors (``*_dev``) for the kernels.
    """

    def __init__(
        self,
        packed_u32: np.ndarray,
        bounds: np.ndarray,
        device: torch.device,
    ) -> None:
        packed_u32 = np.ascontiguousarray(packed_u32, dtype=np.uint32)
        if packed_u32.ndim != 2 or packed_u32.shape[1] != HASH_WORDS32:
            raise ValueError(
                f"packed must be uint32[n, {HASH_WORDS32}], got"
                f" {packed_u32.shape}"
            )
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

        host = np.zeros((self.n_pad, HASH_WORDS32), dtype=np.uint32)
        host[:n] = packed_u32
        bounds_pad = np.full(self.n_pad, -1, dtype=np.int32)
        bounds_pad[:n] = clamped
        self.packed = torch.from_numpy(host.view(np.int32)).to(self.device)
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


# -- plain versions ----------------------------------------------------------


def _pm1(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 32] packed words -> f32[..., 1024] over {-1, +1} (all
    1024 storage bits, bit b of word w at position 32w + b)."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    bits = (words.unsqueeze(-1) >> shifts) & 1  # arithmetic shift, then & 1
    return (bits.to(torch.float32) * 2 - 1).flatten(-2)


def _thresh(tol: int) -> int:
    # ham <= tol  <=>  dot >= 1024 - 2 * tol
    return HASH_BITS_PADDED - 2 * int(tol)


def band_counts_plain(state: SearchState, tol: int) -> torch.Tensor:
    """Plain version of ``band_counts_kernel``: int32[row tiles, slots]."""
    dev = state.device
    counts = torch.zeros(
        (state.n_row_tiles, state.slots), dtype=torch.int32, device=dev
    )
    if state.slots == 0:
        return counts
    pm = _pm1(state.packed)
    thresh = _thresh(tol)
    offs = torch.arange(TILE, device=dev)
    for rt in np.nonzero(state.n_ct)[0].tolist():
        nct = int(state.n_ct[rt])
        r0 = rt * TILE
        c0 = int(state.first_ct[rt]) * TILE
        c1 = c0 + nct * TILE
        dot = pm[r0 : r0 + TILE] @ pm[c0:c1].T  # [TILE, nct * TILE]
        rows = (r0 + offs)[:, None]
        cols = torch.arange(c0, c1, device=dev)[None, :]
        adj = (
            (dot >= thresh)
            & (cols > rows)
            & (cols < state.bounds[r0 : r0 + TILE, None])
        )
        counts[rt, :nct] = adj.view(TILE, nct, TILE).sum(dim=(0, 2)).to(
            torch.int32
        )
    return counts


def band_pack_plain(
    state: SearchState, hits: torch.Tensor, tol: int, chunk: int = 256
) -> torch.Tensor:
    """Plain version of ``band_pack_kernel``: int32[H, TILE/32, TILE]."""
    dev = state.device
    n_hits = hits.shape[0]
    words = torch.empty(
        (n_hits, WORDS_PER_COL, TILE), dtype=torch.int32, device=dev
    )
    thresh = _thresh(tol)
    offs = torch.arange(TILE, device=dev)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)[None, None, :, None]
    for h0 in range(0, n_hits, chunk):
        hc = hits[h0 : h0 + chunk].to(torch.int64)
        ridx = hc[:, :1] * TILE + offs  # [hc, TILE] row ids
        cidx = hc[:, 1:] * TILE + offs  # [hc, TILE] column ids
        dot = torch.bmm(
            _pm1(state.packed[ridx]), _pm1(state.packed[cidx]).transpose(1, 2)
        )  # [hc, TILE rows, TILE cols]
        adj = (
            (dot >= thresh)
            & (cidx[:, None, :] > ridx[:, :, None])
            & (cidx[:, None, :] < state.bounds[ridx][:, :, None])
        )
        w = (adj.view(-1, WORDS_PER_COL, 32, TILE).to(torch.int64) << shifts).sum(2)
        words[h0 : h0 + chunk] = torch.where(w >= 2**31, w - 2**32, w).to(
            torch.int32
        )
    return words


# -- kernel wrappers ---------------------------------------------------------


def band_counts(state: SearchState, tol: int) -> torch.Tensor:
    """Phase A: match count per (row tile, band slot), int32[R, slots].

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
        cuda_build.ptr(state.packed, "packed"),
        cuda_build.ptr(state.bounds, "bounds"),
        cuda_build.ptr(state.first_ct_dev, "first_ct"),
        cuda_build.ptr(state.n_ct_dev, "n_ct"),
        cuda_build.ptr(counts, "counts"),
        state.n_row_tiles, state.slots, state.n, _clamp_tol(tol),
        cuda_build.current_stream(state.device),
    )
    cuda_build.check(err, "band_counts_kernel")
    band_counts.launches += 1
    return counts


def band_pack(state: SearchState, hits: torch.Tensor, tol: int) -> torch.Tensor:
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
        cuda_build.ptr(state.packed, "packed"),
        cuda_build.ptr(state.bounds, "bounds"),
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


# -- the two-phase sweep -----------------------------------------------------


def hit_tiles(state: SearchState, counts: torch.Tensor) -> torch.Tensor:
    """Phase A counts -> int32[H, 2] (row tile, column tile) of the tiles
    holding at least one match, in row-major order."""
    nz = torch.nonzero(counts)  # [H, 2]: row tile, band slot
    ct = state.first_ct_dev[nz[:, 0]].to(torch.int64) + nz[:, 1]
    return torch.stack([nz[:, 0], ct], dim=1).to(torch.int32).contiguous()


def decode_words(
    state: SearchState, hits: torch.Tensor, words: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Transposed packed words of the hit tiles -> int64 (i, j) pairs,
    sorted lexicographically, on the state's device."""
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
    key = torch.sort(ii * state.n + jj).values  # int64: n^2 < 2^62
    return key // state.n, key % state.n


def _two_phase(state, tol, counts_fn, pack_fn) -> tuple[np.ndarray, np.ndarray]:
    if state.n == 0:
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
