"""Batch hash: uint8 cubes -> packed 1000-bit DCT sign hashes.

Counterpart of ``vid_dup_finder_lib_tpu/ops/hash_pallas.py`` (the fused
Pallas kernel) and ``ops/hash_kernel.py`` (its XLA twin).  Only the 1000
low-frequency bins of the 3D DCT-II survive into the hash.  Their signs,
bitpacked LSB-first into 32 words per video (the layout of
``VideoHash.packed_u32``), are computed two ways:

* :func:`hash_cubes_plain`, the plain version (a CPU tensor's path): the
  whole transform collapsed into one linear operator D3 [1024, 4096]
  (:func:`d3_operator`), ``sign((cubes - 128) @ D3^T)`` as one fp32 matmul,
  as the TPU kernel computes it;
* ``hash_dct_kernel`` (``csrc/hash_dct.cu``, a CUDA tensor's path): the
  separable form of the golden model, three fp32 contractions (y, then x,
  then t) with the 10 kept rows of the DCT-II matrix, D f32[10, 16]
  (:func:`dct_rows`), 82,560 multiply-adds per cube instead of 4,194,304.

Both accumulate in true fp32 (no TF32): the signs of near-zero coefficients
depend on it, and the tests hold both to the f64 golden model within <= 2
bits per hash.  Flat cubes are the exception for every fp32 order: all
their AC coefficients are exactly zero, so the AC signs are rounding noise
and two fp32 implementations (the kernel and the plain version, or the JAX
package and the golden model) can differ on them in hundreds of bits.  Bin
0 stays exact, and a cube of 128s hashes to all-zero words.

Cube orientation: ``cube[t, x, y] = frame_t[y, x] - 128`` (the reference
writes each frame into the cube transposed), and bin ``i*100 + j*10 + k``
has ``i`` along t, ``j`` along x and ``k`` along y.  D3's columns are in
that ``(t, x, y)`` order; the plain version keeps a k-major copy whose rows
follow the cubes' own memory order ``(t, y, x)``, and the kernel reads the
frames as they lie, so no transpose of the input is ever made.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..definitions import (
    DCT_SIZE,
    HASH_BITS,
    HASH_SIZE,
    HASH_WORDS32,
)
from ..utils import cuda_build
from .golden import dct2_matrix

N_ROWS = 1024  # 1000 hash bins padded to 32 words
CUBE = DCT_SIZE**3  # 4096


@functools.cache
def d3_operator() -> np.ndarray:
    """[1024, 4096] f32: row b = i*100 + j*10 + k computes DCT bin (i, j, k)
    of a cube flattened as ``(t*16 + x)*16 + y``; rows 1000..1023 are 0."""
    d = dct2_matrix(DCT_SIZE, np.float64)
    di = d[:HASH_SIZE]  # kept low-frequency rows, [10, 16]
    d3 = np.zeros((N_ROWS, CUBE), dtype=np.float64)
    d3[:HASH_BITS] = np.einsum("it,jx,ky->ijktxy", di, di, di).reshape(
        HASH_BITS, CUBE
    )
    return d3.astype(np.float32)


def d3_device_layout(d3: np.ndarray) -> np.ndarray:
    """[1024, 4096] ``(t, x, y)``-column operator -> the [4096, 1024]
    k-major copy whose rows follow cube memory order ``(t, y, x)``."""
    d3 = np.asarray(d3, dtype=np.float32)
    if d3.shape != (N_ROWS, CUBE):
        raise ValueError(f"D3 must be [{N_ROWS}, {CUBE}], got {d3.shape}")
    s = DCT_SIZE
    by_cube = d3.reshape(N_ROWS, s, s, s).transpose(0, 1, 3, 2)  # (t, y, x)
    return np.ascontiguousarray(by_cube.reshape(N_ROWS, CUBE).T)


@functools.lru_cache(maxsize=None)
def _d3_on(device: torch.device) -> torch.Tensor:
    """The operator, resident on ``device`` once (16 MB)."""
    return torch.from_numpy(d3_device_layout(d3_operator())).to(device)


def dct_rows() -> np.ndarray:
    """f32[10, 16]: the kept rows of the DCT-II matrix, the kernel's
    operand (``D[k, n] = cos(pi/16 * k * (n + 0.5))``)."""
    return dct2_matrix(DCT_SIZE, np.float64)[:HASH_SIZE].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_on(device: torch.device) -> torch.Tensor:
    """The kernel's factor, resident on ``device`` once (640 bytes)."""
    return torch.from_numpy(dct_rows()).to(device)


def _check_cubes(cubes_u8: torch.Tensor) -> None:
    if cubes_u8.dtype != torch.uint8 or cubes_u8.shape[1:] != (
        DCT_SIZE, DCT_SIZE, DCT_SIZE
    ):
        raise ValueError(
            f"cubes must be uint8[B, 16, 16, 16], got {cubes_u8.dtype}"
            f"{list(cubes_u8.shape)}"
        )


def _operator_for(cubes_u8: torch.Tensor, d3: torch.Tensor | None) -> torch.Tensor:
    if d3 is None:
        return _d3_on(cubes_u8.device)
    if d3.shape != (CUBE, N_ROWS) or d3.dtype != torch.float32:
        raise ValueError(
            f"d3 must be float32[{CUBE}, {N_ROWS}] (d3_device_layout), got"
            f" {d3.dtype}{list(d3.shape)}"
        )
    if d3.device != cubes_u8.device:
        raise ValueError(f"d3 on {d3.device}, cubes on {cubes_u8.device}")
    return d3


def _pack_signs(coeffs: torch.Tensor) -> torch.Tensor:
    """f32[B, 1024] coefficients -> int32[B, 32]: bit b of word w is
    ``coeffs[:, 32*w + b] > 0``."""
    bits = (coeffs > 0).to(torch.int64).view(-1, HASH_WORDS32, 32)
    shifts = torch.arange(32, device=coeffs.device, dtype=torch.int64)
    words = (bits << shifts).sum(dim=2)  # 0 .. 2^32 - 1
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the enclosed float32 matrix products in full fp32 on every
    backend (no TF32 on CUDA, no reduced-precision fp32 path on the CPU),
    and restore the caller's ``torch.get_float32_matmul_precision()`` on
    exit.  The setting is process-wide while the block runs."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def hash_cubes_plain(
    cubes_u8: torch.Tensor, d3: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version of the hash kernel (fp32 matmul, sign, pack).

    The matmul runs under :func:`full_fp32_matmul`: TF32 flips the signs
    of near-zero DCT coefficients."""
    _check_cubes(cubes_u8)
    op = _operator_for(cubes_u8, d3)
    x = cubes_u8.reshape(-1, CUBE).to(torch.float32) - 128.0
    with full_fp32_matmul():
        coeffs = x @ op
    return _pack_signs(coeffs)


def _factor_for(cubes_u8: torch.Tensor, dct: torch.Tensor | None) -> torch.Tensor:
    if dct is None:
        return _dct_on(cubes_u8.device)
    if dct.shape != (HASH_SIZE, DCT_SIZE) or dct.dtype != torch.float32:
        raise ValueError(
            f"dct must be float32[{HASH_SIZE}, {DCT_SIZE}] (dct_rows), got"
            f" {dct.dtype}{list(dct.shape)}"
        )
    if dct.device != cubes_u8.device:
        raise ValueError(f"dct on {dct.device}, cubes on {cubes_u8.device}")
    return dct


def hash_cubes(
    cubes_u8: torch.Tensor,
    d3: torch.Tensor | None = None,
    dct: torch.Tensor | None = None,
) -> torch.Tensor:
    """Hash uint8[B, 16, 16, 16] cubes (frame t, row, col) -> int32[B, 32].

    A CPU tensor goes through :func:`hash_cubes_plain`; ``d3`` overrides
    its collapsed operator (default: :func:`d3_operator` in
    :func:`d3_device_layout`).  A CUDA tensor goes through
    ``hash_dct_kernel`` (launched on the current stream, without
    synchronising); ``dct`` overrides its [10, 16] factor (default:
    :func:`dct_rows`, resident per device).  Each path refuses the other's
    override.
    """
    if cubes_u8.device.type == "cpu":
        if dct is not None:
            raise ValueError(
                "dct= is the CUDA kernel's factor; a CPU tensor runs the"
                " collapsed plain version, which takes d3="
            )
        return hash_cubes_plain(cubes_u8, d3)
    if d3 is not None:
        raise ValueError(
            "d3= is the plain version's collapsed operator; the CUDA kernel"
            " computes the separable DCT and takes its [10, 16] factor as dct="
        )
    _check_cubes(cubes_u8)
    factor = _factor_for(cubes_u8, dct)
    out = torch.empty(
        (cubes_u8.shape[0], HASH_WORDS32), dtype=torch.int32,
        device=cubes_u8.device,
    )
    if out.shape[0] == 0:
        return out
    lib = cuda_build.load_library()
    with torch.cuda.device(cubes_u8.device):
        err = lib.vdf_hash_dct(
            cuda_build.ptr(cubes_u8, "cubes"), cuda_build.ptr(factor, "dct"),
            cuda_build.ptr(out, "out"), cubes_u8.shape[0],
            cuda_build.current_stream(cubes_u8.device),
        )
    cuda_build.check(err, "hash_dct_kernel")
    hash_cubes.launches += 1
    return out


hash_cubes.launches = 0  # kernel launches (CUDA path only)
