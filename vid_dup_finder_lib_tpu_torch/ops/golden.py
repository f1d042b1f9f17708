"""Golden (NumPy, float64) model of the hash pipeline.

This is the parity oracle for every device kernel: crop+resize -> center ->
3D DCT-II -> sign -> bitpack, reproducing the reference's math exactly:

* resize: ``fast_image_resize::Resizer::new()`` default = Lanczos3
  convolution (``vid_dup_finder_common/src/resize_gray.rs:11-54``),
  reproduced as the crate's actual U8 fixed-point two-pass arithmetic:
  horizontal pass then vertical, i16 coefficients at the Normalizer16
  precision (the largest p <= 15 whose rounded coefficients all fit in
  i16), accumulation seeded with 2^(p-1) and arithmetic-shifted back with
  a [0, 255] clamp — each pass rounds to u8, exactly like the crate
  (``crop_resize_f64`` keeps the previous single-round f64 model for
  comparison; the two differ by <= 1 gray level at rounding boundaries).

  CAVEAT (PARITY.md deviation 1): this fixed-point model is RECONSTRUCTED
  from fast_image_resize's published algorithm — it has never been run
  against the actual Rust crate (no Rust toolchain in this environment),
  and ``tests/oracles/reference_vids_hashes.json`` freezes hashes produced
  by THIS code, so a wrong quantization rule (e.g. the Normalizer16
  precision search range, or per-window vs per-axis normalization) would
  not be caught by a self-generated oracle.  Partial independent check:
  Pillow's LANCZOS u8 resampler — the implementation the
  crate's u8 path was ported from, differing only in coefficient
  precision (i16 vs 22-bit i32) — agrees within 1 gray level on <= 3%
  of pixels across source geometries
  (tests/test_golden_model.py::test_crop_resize_vs_pillow), which a
  wrong quantization rule would exceed.  Before treating bit parity
  with the reference binary as established, regenerate a fixture of
  resized cubes/hashes with the real crate offline and commit it as an
  independent oracle.
* DCT: unnormalized DCT-II along each axis of the 16x16x16 cube
  (``raw_dct_ops.rs:107-142``); only coefficient *signs* survive, so any
  uniform positive per-axis scale is parity-equivalent.
* cube orientation: ``cube[t, x, y] = frame_t[y, x] - 128``  — the reference
  writes pixels as ``frames_matrix[[frame, col, row]]`` (``dct_3d.rs:40-44``),
  i.e. each frame enters the cube transposed.
* bits: ``coeff > 0`` over the ``[..10, ..10, ..10]`` corner in C order
  (``dct_3d.rs:55-66``), packed LSB-first (``video_hash.rs:64-70``).
"""

from __future__ import annotations

import numpy as np

from ..crop import Crop
from ..definitions import DCT_SIZE, HASH_SIZE
from ..video_hash import VideoHash, pack_bits

LANCZOS_A = 3.0  # fast_image_resize default filter = Lanczos3


def dct2_matrix(n: int = DCT_SIZE, dtype=np.float64) -> np.ndarray:
    """Unnormalized DCT-II matrix: D[k, j] = cos(pi/n * k * (j + 0.5)).

    ``D @ x`` equals rustdct's ``process_dct2`` on ``x`` (raw_dct_ops.rs:113).
    """
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi / n * k * (j + 0.5)).astype(dtype)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """sinc(x) * sinc(x/3) windowed to |x| < 3."""
    out = np.sinc(x) * np.sinc(x / LANCZOS_A)
    return np.where(np.abs(x) < LANCZOS_A, out, 0.0)


def resize_weights(
    src_size: int,
    dst_size: int,
    crop_start: float = 0.0,
    crop_size: float | None = None,
    dtype=np.float64,
) -> np.ndarray:
    """Dense Lanczos3 convolution weights W[dst_size, src_size].

    ``W @ column_of_pixels`` resizes one axis; weights follow the standard
    convolution-resampler construction (filter support scaled by the
    downsampling factor, per-destination-pixel window, normalized to sum 1)
    used by fast_image_resize's default path.
    """
    if crop_size is None:
        crop_size = float(src_size)
    scale = crop_size / dst_size
    filter_scale = max(scale, 1.0)
    support = LANCZOS_A * filter_scale

    # Window clamping respects the crop region (the reference materializes
    # the crop before resizing, video_hash_builder.rs:199-203, so samples
    # never come from outside it).
    region_lo = max(0, int(np.floor(crop_start)))
    region_hi = min(src_size, int(np.ceil(crop_start + crop_size)))

    w = np.zeros((dst_size, src_size), dtype=np.float64)
    for j in range(dst_size):
        center = crop_start + (j + 0.5) * scale
        lo = max(region_lo, int(center - support + 0.5))
        hi = min(region_hi, int(center + support + 0.5))
        i = np.arange(lo, hi, dtype=np.float64)
        k = _lanczos3((i + 0.5 - center) / filter_scale)
        s = k.sum()
        if s != 0.0:
            k = k / s
        w[j, lo:hi] = k
    return w.astype(dtype)


_FIR_MAX_PRECISION = 15  # i16 coefficient domain (Normalizer16)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Rust's ``f64::round``: half-away-from-zero (numpy rounds half-even)."""
    return np.where(x >= 0.0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _fir_i16_weights(w: np.ndarray) -> tuple[np.ndarray, int]:
    """f64 weights -> (i16-domain integer weights, precision), exactly as
    fast_image_resize's ``Normalizer16`` quantizes one axis' coefficient
    set: the largest precision p <= 15 for which every coefficient times
    2^p rounds into i16, then per-coefficient half-away rounding."""
    vals = w.reshape(-1)
    p = 0
    for cand in range(_FIR_MAX_PRECISION, -1, -1):
        scaled = _round_half_away(vals * float(1 << cand))
        if scaled.max() <= 32767.0 and scaled.min() >= -32768.0:
            p = cand
            break
    k = _round_half_away(w * float(1 << p)).astype(np.int64)
    return k, p


def _fir_pass_u8(px: np.ndarray, k: np.ndarray, p: int) -> np.ndarray:
    """One fixed-point convolution pass over the LAST axis: u8 pixels x
    i16 coefficients -> i32 accumulator seeded with 2^(p-1) -> arithmetic
    shift -> clamp to u8 (fast_image_resize's per-row u8 kernel)."""
    ss = px.astype(np.int64) @ k.T + ((1 << (p - 1)) if p else 0)
    return np.clip(ss >> p, 0, 255).astype(np.uint8)


def crop_resize_golden(
    frame: np.ndarray, crop: Crop | None = None, dst: int = DCT_SIZE
) -> np.ndarray:
    """Crop+resize a grayscale frame (u8 [H, W]) to [dst, dst] u8.

    Equivalent of ``crop_resize_buf`` (resize_gray.rs:11-54) including the
    crate's U8 fixed-point arithmetic: the default ``Resizer`` runs the
    HORIZONTAL convolution first into a u8 temp image (dst width x src
    height), then the VERTICAL convolution — each pass quantizes its
    coefficients to i16 via ``Normalizer16`` and rounds its output to u8.
    The crop window is folded into the per-axis coefficient windows
    (samples never come from outside it, matching the crate's cropped
    ``ResizeOptions``).
    """
    frame = np.asarray(frame)
    h, w = frame.shape
    if crop is None:
        crop = Crop.from_edge_offsets((w, h), 0, 0, 0, 0)
    x, y, cw, ch = crop.as_view_args()
    wh = resize_weights(w, dst, crop_start=float(x), crop_size=float(cw))
    wv = resize_weights(h, dst, crop_start=float(y), crop_size=float(ch))
    kh, ph = _fir_i16_weights(wh)
    kv, pv = _fir_i16_weights(wv)
    temp = _fir_pass_u8(frame, kh, ph)  # [h, dst] u8 (horizontal pass)
    return _fir_pass_u8(temp.T, kv, pv).T  # [dst, dst] u8 (vertical pass)


def crop_resize_f64(
    frame: np.ndarray, crop: Crop | None = None, dst: int = DCT_SIZE
) -> np.ndarray:
    """Previous golden resize: both axes in f64 with ONE final round.

    Kept as the comparison model for the fixed-point parity path above
    (<= 1 gray level apart at rounding boundaries) and as the exact
    continuous-domain twin of the device f32 weight-matrix resize
    (``ops/resize_device.py``).
    """
    frame = np.asarray(frame)
    h, w = frame.shape
    if crop is None:
        crop = Crop.from_edge_offsets((w, h), 0, 0, 0, 0)
    x, y, cw, ch = crop.as_view_args()
    wv = resize_weights(h, dst, crop_start=float(y), crop_size=float(ch))
    wh = resize_weights(w, dst, crop_start=float(x), crop_size=float(cw))
    out = wv @ frame.astype(np.float64) @ wh.T
    return np.clip(np.floor(out + 0.5), 0.0, 255.0).astype(np.uint8)


def dct_2d_debug(matrix: np.ndarray) -> np.ndarray:
    """2D DCT-II with brute-force [-1, 1] normalization.

    Parity shim for the reference's unused-but-kept debug ops
    (raw_dct_ops.rs:8-46); not on the hash path.
    """
    d = dct2_matrix(matrix.shape[0])
    out = d @ matrix.astype(np.float64) @ d.T
    rng = out.max() - out.min()
    return out * (2.0 / rng) if rng else out


def idct_2d_debug(matrix: np.ndarray) -> np.ndarray:
    """Inverse (DCT-III) with [0, 255] normalization (raw_dct_ops.rs:48-78)."""
    d = dct2_matrix(matrix.shape[0])
    out = d.T @ matrix.astype(np.float64) @ d
    rng = out.max() - out.min()
    return out * (255.0 / rng) if rng else out


def dct3_golden(cube: np.ndarray) -> np.ndarray:
    """Unnormalized DCT-II along all three axes of a [16,16,16] f64 cube."""
    d = dct2_matrix()
    # axis 2 (y), then axis 1 (x), then axis 0 (t) — order irrelevant in exact
    # arithmetic; matches raw_dct_ops.rs:113-136's three rounds.
    out = np.einsum("ky,txy->txk", d, cube)
    out = np.einsum("jx,txk->tjk", d, out)
    out = np.einsum("it,tjk->ijk", d, out)
    return out


def frames_to_cube(frames16: np.ndarray) -> np.ndarray:
    """[16,16,16] u8 frames (t, row, col) -> centered f64 cube (t, x, y).

    Reproduces dct_3d.rs:40-44: pixel (col, row) lands at cube[t, col, row],
    centered as luma - 128.
    """
    frames16 = np.asarray(frames16, dtype=np.float64)
    assert frames16.shape == (DCT_SIZE, DCT_SIZE, DCT_SIZE), frames16.shape
    return np.transpose(frames16, (0, 2, 1)) - 128.0


def hash_bits_golden(frames16: np.ndarray) -> np.ndarray:
    """16 frames of 16x16 u8 -> 1000 hash bits (bool, C order over t,x,y)."""
    coeffs = dct3_golden(frames_to_cube(frames16))
    corner = coeffs[:HASH_SIZE, :HASH_SIZE, :HASH_SIZE]
    return (corner > 0.0).reshape(-1)


def golden_hash_from_frames(
    frames: list[np.ndarray] | np.ndarray,
    src_path: str = "",
    duration: int = 0,
    crop: Crop | None = None,
) -> VideoHash:
    """Full golden pipeline: per-frame crop+resize to 16x16, then 3D-DCT sign
    hash.  ``frames`` are u8 [H, W] arrays (>= 16 of them; extras ignored,
    matching ``Dct3d::from_images``'s take(16))."""
    frames = list(frames)
    if len(frames) < DCT_SIZE:
        from ..errors import NotEnoughFrames

        raise NotEnoughFrames()
    small = np.stack(
        [crop_resize_golden(f, crop) for f in frames[:DCT_SIZE]]
    )
    bits = hash_bits_golden(small)
    return VideoHash(pack_bits(bits), src_path, duration)
