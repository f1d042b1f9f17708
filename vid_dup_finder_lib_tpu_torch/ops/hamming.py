"""Banded adjacency dispatch (counterpart of
``vid_dup_finder_lib_tpu/ops/hamming.py``'s ``banded_adjacency``).

* ``backend="host"``: the JAX package's NumPy sweep
  (``banded_adjacency_host``, which imports no jax).
* ``backend="auto"`` or ``"device"``: the two-phase sweep of
  :mod:`.hamming_cuda` on ``device`` -- its kernels on a CUDA device,
  their plain versions on the CPU.

A device failure is an error: nothing falls back to another backend.
"""

from __future__ import annotations

import numpy as np
import torch

from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host

from ..utils.device import resolve_device
from .hamming_cuda import SearchState, banded_adjacency_cuda

BACKENDS = ("auto", "device", "host")


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
    state = SearchState(packed, bounds, resolve_device(device))
    return banded_adjacency_cuda(state, tolerance_int)
