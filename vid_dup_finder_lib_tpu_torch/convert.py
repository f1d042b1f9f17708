"""Carry the JAX package's device state across to the port, as NumPy.

* :func:`pm1_to_packed` turns the +/-1 operand of a JAX
  ``PallasSearchState.pm1`` back into packed rows;
* :func:`search_state_from_numpy` builds the port's ``SearchState``;
* :func:`library_from_numpy` carries the rows of a JAX
  ``IncrementalDeviceLibrary`` (``np.asarray(lib._packed[:lib.n])``) to
  the port's library;
* :func:`d3_from_numpy` takes ``hash_pallas._d3_operator()``'s array to
  the plain version's collapsed operator;
* :func:`dct_rows_from_numpy` takes ``golden.dct2_matrix(16)[:10]`` to the
  CUDA hash kernel's f32[10, 16] factor.
"""

from __future__ import annotations

import numpy as np
import torch

from .definitions import DCT_SIZE, HASH_BITS_PADDED, HASH_SIZE, HASH_WORDS32
from .ops.hamming_cuda import IncrementalDeviceLibrary, SearchState
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


def library_from_numpy(
    packed_u32: np.ndarray, device: torch.device | str | None = None
) -> IncrementalDeviceLibrary:
    """A port library on ``device`` holding ``packed_u32`` (uint32[n, 32])
    as its rows, in the same insertion order."""
    packed_u32 = np.asarray(packed_u32)
    lib = IncrementalDeviceLibrary(device, capacity=max(1, packed_u32.shape[0]))
    lib.append(packed_u32)
    return lib


def d3_from_numpy(
    arr: np.ndarray, device: torch.device | str | None = None
) -> torch.Tensor:
    """A [1024, 4096] f32 collapsed-DCT operator (columns in the
    ``(t, x, y)`` order of ``hash_pallas._d3_operator``) -> the port's
    plain version's operator, for ``hash_cubes(..., d3=...)`` on a CPU
    tensor."""
    return torch.from_numpy(d3_device_layout(arr)).to(resolve_device(device))


def dct_rows_from_numpy(
    arr: np.ndarray, device: torch.device | str | None = None
) -> torch.Tensor:
    """The kept rows of the DCT-II matrix, [10, 16] in any float type
    (``golden.dct2_matrix(16, np.float64)[:10]``) -> the CUDA hash kernel's
    f32 factor, for ``hash_cubes(..., dct=...)``."""
    arr = np.asarray(arr)
    if arr.shape != (HASH_SIZE, DCT_SIZE):
        raise ValueError(f"DCT rows must be [{HASH_SIZE}, {DCT_SIZE}], got {arr.shape}")
    return torch.from_numpy(arr.astype(np.float32)).to(resolve_device(device))
