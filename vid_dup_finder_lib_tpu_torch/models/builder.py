"""VideoHashBuilder: single-video hash generation.

Behavioral port of the reference's builder
(``vid_dup_finder_lib/src/video_hashing/video_hash_builder.rs``), including
its quirks (SURVEY.md section 7.4):

* the fps/seek policy has four video-length classes and targets 64 frames,
  but only DCT_SIZE=16 frames are consumed (``:112-146`` vs ``:165``) — so a
  hash covers roughly a quarter of the nominal hash window;
* fps is expressed as the integer fraction ``(int(fps * 16384), 16384)``;
* duration is probed twice per video (``:94`` and ``:220``);
* frames must all share one size; the detected crop is applied to every
  frame before the 16x16 resize.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from ..crop import Crop
from ..definitions import (
    Cropdetect,
    DCT_SIZE,
    DEFAULT_VID_HASH_DURATION,
    DEFAULT_VID_HASH_SKIP_FORWARD,
)
from ..errors import NotEnoughFrames, NotVideo, VidProc
from ..ingest.backend import FrameReadCfg, get_duration
from ..ops import letterbox as lb
from ..video_hash import VideoHash


@dataclass(frozen=True)
class CreationOptions:
    """(video_hash_builder.rs:18-63)"""

    skip_forward_amount: float = DEFAULT_VID_HASH_SKIP_FORWARD
    duration: float = DEFAULT_VID_HASH_DURATION
    cropdetect: Cropdetect = Cropdetect.LETTERBOX


DEFAULT_CREATION_OPTIONS = CreationOptions()


def build_frame_reader(
    src_path: str | os.PathLike, opts: CreationOptions
) -> FrameReadCfg:
    """fps/seek policy (video_hash_builder.rs:85-157)."""
    src_path = os.fspath(src_path)
    cfg = FrameReadCfg.from_path(src_path)

    try:
        vid_duration = get_duration(src_path)
    except Exception as e:
        raise NotVideo() from e

    max_seek_amount = opts.skip_forward_amount
    max_hash_duration = opts.duration

    if vid_duration < 2.0:
        fps = 64.0
        seek_amount = 0.0
    elif vid_duration < max_hash_duration:
        # duration exactly 2.0 gives fps = inf (Rust f64 division);
        # Python float division would raise ZeroDivisionError instead
        denom = vid_duration - 2.0
        fps = 64.0 / denom if denom > 0.0 else math.inf
        seek_amount = 0.0
    elif vid_duration < max_seek_amount + max_hash_duration:
        fps = 64.0 / max_hash_duration
        seek_amount = vid_duration - max_hash_duration - 2.0
    else:
        fps = 64.0 / max_hash_duration
        seek_amount = max_seek_amount

    raw = fps * 16384.0
    # Rust's `as u64` cast saturates (video_hash_builder.rs:146): a video
    # of exactly 2.0 s makes fps infinite and the reference carries
    # u64::MAX instead of crashing — mirror that, don't divide-by-zero
    if math.isfinite(raw) and raw < 2.0**64:
        fps_num = max(0, int(raw))
    else:
        fps_num = 2**64 - 1
    cfg.set_fps((fps_num, 16384))
    if seek_amount > 0.0:
        cfg.set_start_offset(seek_amount)
    return cfg


def iterate_video_frames(cfg: FrameReadCfg) -> list[np.ndarray]:
    """Take the first DCT_SIZE frames (video_hash_builder.rs:159-167)."""
    frames: list[np.ndarray] = []
    try:
        for f in cfg.spawn_gray():
            frames.append(f)
            if len(frames) >= DCT_SIZE:
                break
    except VidProc:
        raise
    except Exception as e:
        raise VidProc(f"{e!r}") from e
    if not frames:
        raise VidProc("None")
    return frames


def detect_crop(
    frames: list[np.ndarray], detect_method: Cropdetect
) -> Crop | None:
    if detect_method is Cropdetect.NONE:
        return lb.cropdetect_none(frames)
    if detect_method is Cropdetect.LETTERBOX:
        return lb.cropdetect_letterbox(frames)
    from ..ops.motion import cropdetect_motion

    return cropdetect_motion(frames)


def crop_video_frames(
    frames: list[np.ndarray], cropdetect_algo: Cropdetect
) -> list[np.ndarray]:
    """Equal-size check + crop application (video_hash_builder.rs:188-204)."""
    for f1, f2 in zip(frames, frames[1:]):
        if f1.shape != f2.shape:
            raise VidProc(
                "frames not all same size: Expected "
                f"{f1.shape[::-1]}, Actual {f2.shape[::-1]}"
            )
    crop = detect_crop(frames, cropdetect_algo)
    if crop is None:
        raise NotEnoughFrames()
    x, y, w, h = crop.as_view_args()
    return [f[y : y + h, x : x + w] for f in frames]


def hash_frames(
    frames: list[np.ndarray], src_path: str, duration: int
) -> VideoHash:
    """VideoHash::from_frames equivalent (video_hash.rs:45-73): per-frame
    Lanczos3 resize to 16x16, then the 3D-DCT sign hash (golden host path;
    the batched pipeline uses the device kernel instead)."""
    from ..ops.golden import crop_resize_golden, hash_bits_golden
    from ..video_hash import pack_bits

    if len(frames) < DCT_SIZE:
        raise NotEnoughFrames()
    small = np.stack(
        [crop_resize_golden(f) for f in frames[:DCT_SIZE]]
    )
    return VideoHash(pack_bits(hash_bits_golden(small)), src_path, duration)


def prepare_frames(
    src_path: str | os.PathLike, opts: CreationOptions
) -> tuple[np.ndarray, int]:
    """Decode + crop + resize: everything host-side of the DCT.

    Returns (uint8[16, 16, 16] cube in (t, row, col) order, duration_secs).
    Used by both the single-video path and the batched device pipeline.
    """
    from ..ops.golden import crop_resize_golden

    src_path = os.fspath(src_path)
    cfg = build_frame_reader(src_path, opts)
    frames = iterate_video_frames(cfg)
    frames = crop_video_frames(frames, opts.cropdetect)
    if len(frames) < DCT_SIZE:
        raise NotEnoughFrames()
    duration = int(get_duration(src_path))  # probed again, as the ref does
    cube = np.stack([crop_resize_golden(f) for f in frames[:DCT_SIZE]])
    return cube, duration


def prepare_raw_frames(
    src_path: str | os.PathLike, opts: CreationOptions
) -> tuple[np.ndarray, Crop | None, int]:
    """Decode + host crop *detection* only — no host pixel resampling.

    The device-preproc pipeline path (reference hot loop #3,
    video_hash.rs:59, moved onto the MXU): returns
    (uint8[16, H, W] raw frames, crop, duration_secs).  For LETTERBOX the
    crop is None — detection runs batched on device
    (``ops/letterbox_device``); MOTION/NONE crops are detected here (the
    motion morphology is scipy by design) and applied on device as part
    of the resize weights.
    """
    src_path = os.fspath(src_path)
    cfg = build_frame_reader(src_path, opts)
    frames = iterate_video_frames(cfg)
    # equal-size check, as crop_video_frames does (video_hash_builder.rs:188)
    for f1, f2 in zip(frames, frames[1:]):
        if f1.shape != f2.shape:
            raise VidProc(
                "frames not all same size: Expected "
                f"{f1.shape[::-1]}, Actual {f2.shape[::-1]}"
            )
    if opts.cropdetect is Cropdetect.LETTERBOX:
        crop = None
    else:
        crop = detect_crop(frames, opts.cropdetect)
        if crop is None:
            raise NotEnoughFrames()
    if len(frames) < DCT_SIZE:
        raise NotEnoughFrames()
    duration = int(get_duration(src_path))  # probed again, as the ref does
    return np.stack(frames[:DCT_SIZE]), crop, duration


def gen_hash(src_path: str | os.PathLike, opts: CreationOptions) -> VideoHash:
    """(video_hash_builder.rs:214-223)"""
    src_path = os.fspath(src_path)
    cfg = build_frame_reader(src_path, opts)
    frames = iterate_video_frames(cfg)
    frames = crop_video_frames(frames, opts.cropdetect)
    duration = int(get_duration(src_path))
    return hash_frames(frames, src_path, duration)


@dataclass
class VideoHashBuilder:
    """(video_hash_builder.rs:69-83)"""

    options: CreationOptions = DEFAULT_CREATION_OPTIONS

    @staticmethod
    def from_options(options: CreationOptions) -> "VideoHashBuilder":
        return VideoHashBuilder(options)

    def hash(self, src_path: str | os.PathLike) -> VideoHash:
        return gen_hash(src_path, self.options)
