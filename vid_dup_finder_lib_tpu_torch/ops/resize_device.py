"""Batched crop + resize on the device, bit-exact with the host golden path.

Counterpart of ``vid_dup_finder_lib_tpu/ops/resize_device.py``.  The
Lanczos3 crop + resize of ``golden.crop_resize_golden`` is two fixed-point
passes per frame, horizontal then vertical: i16 coefficients at the
Normalizer16 precision ``p``, a ``2^(p-1)`` rounding seed, an arithmetic
shift by ``p`` and a u8 clamp after each pass.  For a batch of videos of
one resolution and crop, each pass is one float32 matrix product with the
bucket's integer weights (:func:`_weights_for`, built from the host golden
path's own ``resize_weights`` and ``_fir_i16_weights``, so the host and
device weights cannot drift apart).

Exactness: the coefficients are integers with |k| <= 2^15 and the pixels
u8, so every product and every partial sum (<= 255 * sum|k| < 2^24) is an
integer that float32 holds exactly; the products must run in true fp32
(:func:`.hash_kernel.full_fp32_matmul`), since TF32 keeps 10 mantissa bits.
``floor((acc + 2^(p-1)) * 2^-p)`` is then the host's arithmetic shift.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crop import Crop
from ..definitions import DCT_SIZE
from .golden import _fir_i16_weights, resize_weights
from .hash_kernel import full_fp32_matmul

SUB_BATCH_BYTES = 256 * 2**20  # float32 frames cast at once


@functools.lru_cache(maxsize=256)
def _weights_for(
    height: int, width: int, crop_args: tuple[int, int, int, int] | None
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(K_v [16, H], K_h [16, W] integer-valued f32, p_v, p_h) for one
    (resolution, crop) bucket: i16 fixed-point coefficients identical to
    the host golden path's."""
    if crop_args is None:
        x, y, cw, ch = 0, 0, width, height
    else:
        x, y, cw, ch = crop_args
    wv = resize_weights(height, DCT_SIZE, crop_start=float(y), crop_size=float(ch))
    wh = resize_weights(width, DCT_SIZE, crop_start=float(x), crop_size=float(cw))
    kv, pv = _fir_i16_weights(wv)
    kh, ph = _fir_i16_weights(wh)
    return kv.astype(np.float32), kh.astype(np.float32), pv, ph


def _fixed_point_round(acc: torch.Tensor, p: int) -> torch.Tensor:
    """u8 of ``(acc + 2^(p-1)) >> p``, in place on the float accumulator."""
    if p:
        acc.add_(float(1 << (p - 1))).mul_(1.0 / float(1 << p))
    return acc.floor_().clamp_(0.0, 255.0)


def resize_frames_device(
    frames: torch.Tensor, crop: Crop | None = None
) -> torch.Tensor:
    """uint8[B, 16, H, W] frames of one resolution and crop ->
    uint8[B, 16, 16, 16] cubes (frame, row, column), on the frames'
    device; each frame equal to ``golden.crop_resize_golden(frame, crop)``.

    The frames are cast to float32 in sub-batches of at most
    ``SUB_BATCH_BYTES`` (one video at least), not the whole batch at once."""
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[1] != DCT_SIZE:
        raise ValueError(
            f"frames must be uint8[B, {DCT_SIZE}, H, W], got"
            f" {frames.dtype}{list(frames.shape)}"
        )
    b, t, h, w = frames.shape
    dev = frames.device
    kv, kh, pv, ph = _weights_for(h, w, None if crop is None else crop.as_view_args())
    kv = torch.from_numpy(kv).to(dev)  # [16, H]
    kh_t = torch.from_numpy(kh.T.copy()).to(dev)  # [W, 16]
    out = torch.empty((b, t, DCT_SIZE, DCT_SIZE), dtype=torch.uint8, device=dev)
    step = max(1, SUB_BATCH_BYTES // (4 * t * h * w))
    with full_fp32_matmul():
        for b0 in range(0, b, step):
            x = frames[b0 : b0 + step].to(torch.float32)
            x = _fixed_point_round(x @ kh_t, ph)  # horizontal: [b, t, H, 16]
            x = _fixed_point_round(kv @ x, pv)  # vertical: [b, t, 16, 16]
            out[b0 : b0 + step] = x.to(torch.uint8)
    return out
