"""Motion-based autocrop.

Behavioral port of ``MotiondetectCrop``
(``vid_dup_finder_common/src/motioncrop/``): find the screen region that
actually contains moving video content, so windowed/pillarboxed re-uploads
hash the same as their originals.

Pipeline (autocrop_frames.rs:36-311):
  contrast stretch (only when no saturated pixels) -> letterbox-union +
  whiten the letterbox ring -> two candidate passes of
  [darkest-frame mask AND motion mask -> connected components -> largest
  region -> bbox -> erode x2] -> candidate filtering (aspect <= 3,
  area > 0.8 * max, topmost) -> fallback to the letterbox crop.

Image-op semantics follow the Rust image/imageproc crates, which the
reference's pixel-level unit tests pin down:
  * blur: Gaussian sigma=2, taps at integer offsets within 2*sigma support,
    window clipped at borders and weights renormalized, separable passes
    with u8 rounding between them (image::imageops::sample);
  * threshold: strictly-greater -> 255 (imageproc::contrast::threshold);
  * morphology: LInf (square) structuring elements; out-of-image pixels are
    neither foreground (dilate) nor background (erode), matching
    imageproc's distance-transform formulation;
  * connected components: 8-connected, background 0, raster-order labels.

This stage runs on <= 16 small host frames per video (SURVEY.md 2.2), so it
is NumPy/SciPy host code by design; the device path consumes its crop.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from ..crop import Crop
from .letterbox import AnyColour, letterbox_crop_frame

_EIGHT = np.ones((3, 3), dtype=bool)


# -- image/imageproc-faithful primitives ---------------------------------------


def _gaussian_taps(sigma: float) -> np.ndarray:
    support = int(np.ceil(2.0 * sigma)) if 2.0 * sigma % 1 else int(2.0 * sigma)
    offs = np.arange(-support, support + 1, dtype=np.float64)
    return np.exp(-(offs**2) / (2.0 * sigma * sigma))


def _blur_pass(img: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """One separable pass with border-clipped renormalized weights, rounded
    back to u8 (image::imageops::sample behavior)."""
    r = len(taps) // 2
    x = img.astype(np.float64)
    n = x.shape[axis]
    acc = np.zeros_like(x)
    wsum = np.zeros_like(x)
    for o, w in zip(range(-r, r + 1), taps):
        lo_src = max(0, o)
        hi_src = min(n, n + o)
        if hi_src <= lo_src:
            continue
        src = np.take(x, np.arange(lo_src, hi_src), axis=axis)
        pad_before = lo_src - o
        pad_after = n - (hi_src - o)
        pads = [(0, 0), (0, 0)]
        pads[axis] = (pad_before, pad_after)
        mask = np.ones_like(src)
        acc += np.pad(src * w, pads)
        wsum += np.pad(mask * w, pads)
    out = acc / wsum
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def gaussian_blur_u8(img: np.ndarray, sigma: float) -> np.ndarray:
    # image::imageops::blur samples vertically first, then horizontally,
    # with u8 rounding between the passes; the order matters at 1-LSB scale
    # and that LSB feeds the >20 motion threshold.
    taps = _gaussian_taps(sigma)
    return _blur_pass(_blur_pass(img, taps, axis=0), taps, axis=1)


def threshold_binary(img: np.ndarray, thresh: int) -> np.ndarray:
    """> thresh -> 255 else 0."""
    return np.where(img > thresh, 255, 0).astype(np.uint8)


def dilate_linf(mask: np.ndarray, k: int) -> np.ndarray:
    """255/0 mask; out-of-image is background."""
    m = ndimage.maximum_filter(mask, size=2 * k + 1, mode="constant", cval=0)
    return m.astype(np.uint8)


def erode_linf(mask: np.ndarray, k: int) -> np.ndarray:
    """255/0 mask; out-of-image is NOT background (imageproc erode uses the
    in-image distance transform only)."""
    m = ndimage.minimum_filter(mask, size=2 * k + 1, mode="constant", cval=255)
    return m.astype(np.uint8)


def morph_close_linf(mask: np.ndarray, k: int) -> np.ndarray:
    return erode_linf(dilate_linf(mask, k), k)


def morph_open_linf(mask: np.ndarray, k: int) -> np.ndarray:
    return dilate_linf(erode_linf(mask, k), k)


def regionize(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connected components over nonzero pixels, raster-order labels
    (motioncrop/utils.rs:7-14)."""
    labels, n = ndimage.label(mask != 0, structure=_EIGHT)
    return labels.astype(np.int64), int(n)


def largest_region(labels: np.ndarray) -> int | None:
    """Label with the max pixel count; ties -> highest label, matching
    Rust's max_by which keeps the last maximum (utils.rs:62-75)."""
    counts = np.bincount(labels.reshape(-1))
    if counts.size <= 1:
        return None
    counts = counts.copy()
    counts[0] = -1
    best = counts.max()
    if best <= 0:
        return None
    return int(np.flatnonzero(counts == best)[-1])


def stretch_contrast(img: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Map [lo, hi] -> [0, 255] (imageproc stretch_contrast_mut)."""
    x = img.astype(np.float64)
    out = (x - lo) * 255.0 / (hi - lo)
    return np.clip(out, 0, 255).astype(np.uint8)


# -- FrameChange (frame_change.rs) ------------------------------------------------


def motion_mask(frames: list[np.ndarray]) -> np.ndarray:
    """Accumulated, postprocessed motion-intensity mask
    (frame_change.rs:42-84): sum over consecutive pairs of |a-b| (diffs < 8
    zeroed), normalize u16 -> u8, blur sigma=2, threshold > 20,
    close LInf 5."""
    acc = np.zeros(frames[0].shape, dtype=np.uint16)
    for a, b in zip(frames, frames[1:]):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32)).astype(np.uint16)
        diff[diff < 8] = 0
        acc += diff
    # normalize_u16: (p - min) * 65535 / (max - min), truncating
    mn, mx = int(acc.min()), int(acc.max())
    if mx != mn:
        norm = (
            (acc.astype(np.float64) - mn) * (65535.0 / (mx - mn))
        ).clip(0, 65535).astype(np.uint16)
    else:
        norm = np.zeros_like(acc)
    # u16 -> u8 conversion (image crate convert: scale with rounding)
    as_u8 = np.round(norm.astype(np.float64) * 255.0 / 65535.0).astype(np.uint8)
    blurred = gaussian_blur_u8(as_u8, 2.0)
    binary = threshold_binary(blurred, 20)
    return morph_close_linf(binary, 5)


# -- DarkestFrame (darkest_frame.rs) ------------------------------------------------


def darkest_mask(frames: list[np.ndarray]) -> np.ndarray:
    """Per-pixel min over frames, then binarize: pixels >= 210 are
    background (0), the rest foreground 255 (darkest_frame.rs:43-69)."""
    dark = frames[0]
    for f in frames[1:]:
        dark = np.minimum(dark, f)
    return np.where(dark >= 210, 0, 255).astype(np.uint8)


def largest_dark_region_with_motion(
    dark: np.ndarray, motion: np.ndarray
) -> np.ndarray | None:
    """(darkest_frame.rs:84-111)"""
    h = dark.shape[0]
    erode_thr = min(h // 10, 10)
    pp = morph_open_linf(dark, erode_thr) if h > 100 else dark

    anded = ((pp == 255) & (motion == 255)).astype(np.uint8) * 255

    labels, _ = regionize(pp)
    preserved_idxs = np.unique(labels[anded == 255])
    preserved = np.where(np.isin(labels, preserved_idxs), labels, 0)

    li = largest_region(preserved)
    if li is None:
        return None
    return (preserved == li).astype(np.uint8) * 255


def view_mask_bbox(mask: np.ndarray) -> tuple[int, int, int, int] | None:
    """bbox (x, y, w, h) of 255 pixels (motioncrop/utils.rs:105-137)."""
    ys, xs = np.nonzero(mask == 255)
    if ys.size == 0:
        return None
    return (
        int(xs.min()),
        int(ys.min()),
        int(xs.max() - xs.min() + 1),
        int(ys.max() - ys.min() + 1),
    )


# -- MotiondetectCrop (autocrop_frames.rs) -------------------------------------------


def _from_frames_one(frames: list[np.ndarray]) -> Crop | None:
    """(autocrop_frames.rs:224-311)"""
    dark = darkest_mask(frames)
    motion = motion_mask(frames)
    retained = largest_dark_region_with_motion(dark, motion)
    if retained is None:
        return None
    bbox = view_mask_bbox(retained)
    if bbox is None:
        return None
    x, y, w, h = bbox
    oh, ow = frames[0].shape
    ret = Crop.from_topleft_and_dims((ow, oh), x, y, w, h)
    if ret.is_uncropped():
        return ret
    eroded = ret.eroded()
    eroded = eroded.eroded() if eroded is not None else None
    return eroded if eroded is not None else ret


def cropdetect_motion(frames: list[np.ndarray]) -> Crop | None:
    """(autocrop_frames.rs:36-220)"""
    frames = [np.asarray(f).copy() for f in frames]
    if len(frames) < 2:
        return None

    min_pix = min(int(f.min()) for f in frames)
    max_pix = max(int(f.max()) for f in frames)
    if max_pix != 255 and min_pix != 0 and min_pix < max_pix:
        frames = [stretch_contrast(f, min_pix, max_pix) for f in frames]

    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        return None

    # letterbox union over ALL frames (autocrop_frames.rs:124-138)
    letterbox = letterbox_crop_frame(frames[0], AnyColour(16))
    for f in frames[1:]:
        letterbox = letterbox.union(letterbox_crop_frame(f, AnyColour(16)))

    # whiten the letterbox ring
    oh, ow = frames[0].shape
    x, y, w, h = letterbox.as_view_args()
    ring = np.ones((oh, ow), dtype=bool)
    ring[y : y + h, x : x + w] = False
    for f in frames:
        f[ring] = 255

    crop_1 = _from_frames_one(frames)
    if crop_1 is not None:
        cx, cy, cw, ch = crop_1.as_view_args()
        for f in frames:
            f[cy : cy + ch, cx : cx + cw] = 255  # clear_out_cropped_area
        crop_2 = _from_frames_one(frames)
    else:
        crop_2 = None

    crops = [c for c in (crop_1, crop_2) if c is not None]
    if not crops:
        return letterbox

    largest_area = max(c.area for c in crops)
    candidates = [
        c
        for c in crops
        if max(c.aspect_ratio, 1.0 / c.aspect_ratio) <= 3.0
        and c.area > largest_area * 0.8
    ]
    if not candidates:
        return letterbox
    return min(candidates, key=lambda c: c.top)
