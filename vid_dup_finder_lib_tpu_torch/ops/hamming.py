"""Banded and references adjacency dispatch (counterpart of
``vid_dup_finder_lib_tpu/ops/hamming.py``'s ``banded_adjacency`` and of
``hamming_pallas.refs_adjacency_pallas``).

Backends of :func:`banded_adjacency`:

* ``"host"``: the JAX package's NumPy sweep (``banded_adjacency_host``,
  which imports no jax).
* ``"auto"`` or ``"device"``: the two-phase sweep of :mod:`.hamming_cuda`
  (K2 + K3) on ``device`` -- its kernels on a CUDA device, their plain
  versions on the CPU.
* ``"band"``: the whole-band sweep of :mod:`.hamming_band` (K4) on
  ``device``, the same way.

:func:`refs_adjacency` runs K2 + K3 in their per-row window mode.  A device
failure is an error: nothing falls back to another backend.
"""

from __future__ import annotations

import numpy as np
import torch

from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host

from ..utils.device import resolve_device
from .hamming_band import banded_adjacency_band
from .hamming_cuda import (
    RefsState,
    SearchState,
    banded_adjacency_cuda,
    refs_adjacency_cuda,
)

BACKENDS = ("auto", "device", "host", "band")


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
    state = SearchState(packed, bounds, resolve_device(device))
    return banded_adjacency_cuda(state, tolerance_int)


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
