"""Letterbox (black-bar) detection.

Behavioral port of ``VdfFrameExt::letterbox_crop``
(``vid_dup_finder_common/src/video_frames_gray.rs:38-163``), vectorized:
instead of per-strip pixel scans, whole-frame 256-bin histograms per
row/column give each strip's modal count in one shot, and the per-side
"count consecutive letterbox strips" becomes a take-while over a boolean
vector.

Semantics preserved exactly:
* a strip is letterbox when > 90% of its pixels match;
* ``BlackWhite(tol)``: pixel <= tol or >= 255 - tol;
* ``AnyColour(tol)``: pixel within tol of the strip's modal value
  (ties broken by the *highest* value, matching Rust's
  ``max_by_key`` which prefers later elements on ties);
* fallback to no-crop when the whole frame matched
  (video_frames_gray.rs:119-127);
* sequence-level detection unions per-frame crops over
  ``frames[::8][:8]`` with ``AnyColour(16)`` (video_frames_gray.rs:201-210).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crop import Crop

MIN_PROPORTION = 0.9


@dataclass(frozen=True)
class BlackWhite:
    tol: int


@dataclass(frozen=True)
class AnyColour:
    tol: int


LetterboxColour = BlackWhite | AnyColour


def _strip_is_letterbox(strips: np.ndarray, colour: LetterboxColour) -> np.ndarray:
    """strips: u8[n_strips, strip_len] -> bool[n_strips]."""
    n, m = strips.shape
    if isinstance(colour, BlackWhite):
        matching = (
            (strips <= colour.tol) | (strips >= 255 - colour.tol)
        ).sum(axis=1)
    else:
        # per-strip histogram
        hist = np.zeros((n, 256), dtype=np.int32)
        rows = np.repeat(np.arange(n), m)
        np.add.at(hist, (rows, strips.reshape(-1)), 1)
        # Rust max_by_key returns the LAST maximal element -> highest value.
        rev_argmax = 255 - np.argmax(hist[:, ::-1], axis=1)
        csum = np.cumsum(hist, axis=1)
        lo = np.maximum(rev_argmax - colour.tol, 0)
        hi = np.minimum(rev_argmax + colour.tol, 255)
        idx = np.arange(n)
        matching = csum[idx, hi] - np.where(lo > 0, csum[idx, lo - 1], 0)
    return matching.astype(np.float64) / m > MIN_PROPORTION


def _take_while_count(flags: np.ndarray) -> int:
    nz = np.flatnonzero(~flags)
    return int(nz[0]) if nz.size else int(flags.size)


def letterbox_crop_frame(frame: np.ndarray, colour: LetterboxColour) -> Crop:
    """Detect the letterbox of one grayscale frame (u8 [H, W])."""
    frame = np.asarray(frame)
    h, w = frame.shape
    cols = frame.T  # [W, H]: columns as strips
    rows = frame  # [H, W]: rows as strips

    l = _take_while_count(_strip_is_letterbox(cols, colour))
    r = _take_while_count(_strip_is_letterbox(cols[::-1], colour))
    t = _take_while_count(_strip_is_letterbox(rows, colour))
    b = _take_while_count(_strip_is_letterbox(rows[::-1], colour))

    if (w - l - r >= 1) and (h - t - b >= 1):
        return Crop.from_edge_offsets((w, h), l, r, t, b)
    return Crop.from_edge_offsets((w, h), 0, 0, 0, 0)


def cropdetect_none(frames: list[np.ndarray]) -> Crop | None:
    """(video_frames_gray.rs:195-199)"""
    if not frames:
        return None
    h, w = frames[0].shape
    return Crop.from_edge_offsets((w, h), 0, 0, 0, 0)


def cropdetect_letterbox(frames: list[np.ndarray]) -> Crop | None:
    """Union of per-frame letterbox crops over frames[::8][:8]
    (video_frames_gray.rs:201-210)."""
    sel = frames[::8][:8]
    if not sel:
        return None
    crops = [letterbox_crop_frame(f, AnyColour(16)) for f in sel]
    out = crops[0]
    for c in crops[1:]:
        out = out.union(c)
    return out


def sequence_letterbox_crop(frames: list[np.ndarray]) -> Crop:
    """All-frames union with AnyColour(16) (video_frames_gray.rs:148-163),
    used by the motion-crop preprocessing."""
    crops = [letterbox_crop_frame(f, AnyColour(16)) for f in frames]
    out = crops[0]
    for c in crops[1:]:
        out = out.union(c)
    return out
