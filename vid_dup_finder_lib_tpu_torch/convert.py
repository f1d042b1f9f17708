"""Carry the JAX package's device state across to the port, as NumPy.

* :func:`pm1_to_packed` turns the +/-1 operand of a JAX
  ``PallasSearchState.pm1`` back into packed rows;
* :func:`search_state_from_numpy` builds the port's ``SearchState``;
* :func:`d3_from_numpy` takes ``hash_pallas._d3_operator()``'s array to
  the port's device operator.
"""

from __future__ import annotations

import numpy as np
import torch

from .definitions import HASH_BITS_PADDED, HASH_WORDS32
from .ops.hamming_cuda import SearchState
from .ops.hash_kernel import d3_device_layout
from .utils.device import resolve_device


def pm1_to_packed(pm1: np.ndarray) -> np.ndarray:
    """int8[n, 1024] over {-1, +1} -> uint32[n, 32]: bit b of word w is
    ``pm1[:, 32*w + b] > 0``."""
    pm1 = np.asarray(pm1)
    if pm1.ndim != 2 or pm1.shape[1] != HASH_BITS_PADDED:
        raise ValueError(f"pm1 must be [n, {HASH_BITS_PADDED}], got {pm1.shape}")
    bits = (pm1 > 0).reshape(-1, HASH_WORDS32, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32
    )


def search_state_from_numpy(
    packed_u32: np.ndarray,
    bounds: np.ndarray,
    device: torch.device | str | None = None,
) -> SearchState:
    """The port's resident search state for a duration-sorted library."""
    return SearchState(packed_u32, bounds, resolve_device(device))


def d3_from_numpy(
    arr: np.ndarray, device: torch.device | str | None = None
) -> torch.Tensor:
    """A [1024, 4096] f32 collapsed-DCT operator (columns in the
    ``(t, x, y)`` order of ``hash_pallas._d3_operator``) -> the port's
    device operator, for ``hash_cubes(..., d3=...)``."""
    return torch.from_numpy(d3_device_layout(arr)).to(resolve_device(device))
