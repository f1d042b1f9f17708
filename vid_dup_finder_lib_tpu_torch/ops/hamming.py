"""Banded and references adjacency dispatch (counterpart of
``vid_dup_finder_lib_tpu/ops/hamming.py``'s ``banded_adjacency`` and of
``hamming_pallas.refs_adjacency_pallas``).

Backends of :func:`banded_adjacency`:

* ``"host"``: :func:`banded_adjacency_host`, a NumPy sweep (the JAX
  package's ``banded_adjacency_host``, copied).
* ``"native"``: the C++ XOR + POPCNT sweep of :mod:`..native` on the host's
  cores, whatever ``device`` is; raises when the library cannot be built.
* ``"device"``: the two-phase sweep of :mod:`.hamming_cuda` (K2 + K3) on
  ``device`` -- its kernels on a CUDA device, their plain versions on the
  CPU.
* ``"band"``: the whole-band sweep of :mod:`.hamming_band` (K4) on
  ``device``, the same way.
* ``"ring"``: the two-phase sweep over the shards of
  ``parallel.mesh.make_mesh(device=device)`` (:mod:`..parallel.ring_cuda`):
  every visible card, or one CPU shard.  Only when asked for: ``auto``
  never takes it.  (The JAX package's ``auto`` does on several chips from
  a size set for TPU chips, ``ops/hamming.py:466-499``; the port sets no
  such size before it has measured one across cards.)
* ``"auto"``: on a CUDA device the two-phase sweep; on the CPU the native
  sweep when its library is available, else the two-phase sweep's plain
  versions (the JAX package's choice on a host without an accelerator,
  ``ops/hamming.py:544-565``).

:func:`refs_adjacency` runs K2 + K3 in their per-row window mode.  A device
failure is an error, and an explicit backend never gives way to another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..definitions import HASH_BITS_PADDED
from .. import native
from ..utils.device import resolve_device
from .hamming_band import banded_adjacency_band
from .hamming_cuda import (
    RefsState,
    SearchState,
    banded_adjacency_cuda,
    refs_adjacency_cuda,
)

BACKENDS = ("auto", "device", "host", "band", "native", "ring")

_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def unpack_pm1_host(packed: np.ndarray, dtype=np.float32) -> np.ndarray:
    """uint32[N, 32] -> {-1, +1}[N, 1024] over all 1024 storage bits, like
    the reference's per-word popcount (video_hash.rs:311-317):
    dot(a, b) = 1024 - 2 * hamming."""
    n = packed.shape[0]
    bits = (packed[:, :, None] >> _BIT_SHIFTS[None, None, :]) & np.uint32(1)
    pm = (bits.astype(np.int8) * 2 - 1).reshape(n, HASH_BITS_PADDED)
    return pm.astype(dtype)


def hamming_matrix_host(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """Dense pairwise Hamming distances via XOR+popcount (small inputs)."""
    x = packed_a[:, None, :] ^ packed_b[None, :, :]
    return np.bitwise_count(x).sum(axis=2).astype(np.int64)


def banded_adjacency_host(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    row_block: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), i < j < bounds[i], with hamming <= tolerance_int:
    the banded block sweep in NumPy, an exact-integer f32 dot."""
    n = packed.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pm = unpack_pm1_host(packed)
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        c0 = r0 + 1
        c1 = int(bounds[r0:r1].max())
        if c1 <= c0:
            continue
        dot = pm[r0:r1] @ pm[c0:c1].T  # exact: integers < 2^24 in f32
        dist = (HASH_BITS_PADDED - dot) * 0.5
        rows = np.arange(r0, r1)[:, None]
        cols = np.arange(c0, c1)[None, :]
        adj = (dist <= tolerance_int) & (cols > rows) & (cols < bounds[r0:r1, None])
        if adj.any():
            ii, jj = np.nonzero(adj)
            out_i.append(ii.astype(np.int64) + r0)
            out_j.append(jj.astype(np.int64) + c0)
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_i), np.concatenate(out_j)


def banded_adjacency(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    backend: str = "auto",
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), i < j < bounds[i], with hamming <= tolerance_int,
    as int64 arrays in lexicographic order.  ``packed``: uint32[n, 32]."""
    if backend == "host":
        return banded_adjacency_host(packed, bounds, tolerance_int)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "band":
        return banded_adjacency_band(packed, bounds, tolerance_int, device=device)
    if backend == "native":
        if not native.available():
            raise RuntimeError(
                "backend='native': the native library could not be built from"
                " native_src/vdf_native.cpp (g++ missing or failing)"
            )
        return _banded_adjacency_native(packed, bounds, tolerance_int)
    dev = resolve_device(device)
    if backend == "ring":
        # imported here: a process that never asks for the ring loads none of it
        from ..parallel.mesh import make_mesh
        from ..parallel.ring_cuda import banded_adjacency_ring

        return banded_adjacency_ring(packed, bounds, tolerance_int, mesh=make_mesh(device=dev))
    if backend == "auto" and dev.type == "cpu" and native.available():
        return _banded_adjacency_native(packed, bounds, tolerance_int)
    return banded_adjacency_cuda(SearchState(packed, bounds, dev), tolerance_int)


def _banded_adjacency_native(packed, bounds, tolerance_int):
    packed64 = np.ascontiguousarray(packed, dtype=np.uint32).view(np.uint64)
    return native.banded_adjacency_native(packed64, bounds, tolerance_int)


def refs_adjacency(
    refs_packed: np.ndarray,
    cands_packed: np.ndarray | torch.Tensor,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    device: torch.device | str | None = None,
    n_cands: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), lo[i] <= j < hi[i], with hamming <= tolerance_int,
    as int64 arrays in lexicographic order; empty windows (hi <= lo) give
    no pairs.  ``refs_packed``: uint32[r, 32], ``cands_packed``:
    uint32[n, 32] in duration order (the contract of
    ``hamming_pallas.refs_adjacency_pallas``), or the candidates resident
    on ``device`` as an int32[>= n_pad, 32] tensor with ``n_cands`` rows
    first (the counterpart of its ``cands_dev`` / ``n_cands``)."""
    state = RefsState(
        refs_packed, cands_packed, lo, hi, resolve_device(device), n_cands
    )
    return refs_adjacency_cuda(state, tolerance_int)
