"""Video metadata probing.

``VideoInfo`` mirrors the reference's ffprobe wrapper
(``ffmpeg_cmdline_utils/src/ffmpeg_stats.rs:59-154``): duration, file size,
and resolution with the rotation-aware width/height swap for 90/270-degree
metadata rotation.  When the ffprobe binary is unavailable, an OpenCV
fallback probes the same fields in-process.
"""

from __future__ import annotations

import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path

from ..errors import NotVideo

FFPROBE_TIMEOUT_SECS = 60  # reference watchdog timeout (ffmpeg_ops.rs:18)


def ffprobe_available() -> bool:
    return shutil.which("ffprobe") is not None


@dataclass(frozen=True)
class VideoInfo:
    duration: float  # seconds
    file_size: int
    resolution: tuple[int, int]  # (width, height), rotation-corrected

    @staticmethod
    def new(src_path: str | os.PathLike) -> "VideoInfo":
        if ffprobe_available():
            return VideoInfo._from_ffprobe(src_path)
        try:
            return VideoInfo._from_opencv(src_path)
        except (NotVideo, ImportError):
            pass
        try:
            # third tier: gst preroll probe (mediainfo_utils.rs:13-68)
            # — covers gst-only formats and cv2-less installs
            return VideoInfo._from_gst(src_path)
        except NotVideo:
            # fourth tier: AV1-in-mp4 container metadata (the in-repo
            # demuxer) — AV1 files on installs with neither cv2 nor an
            # AV1-capable gst plugin set
            return VideoInfo._from_av1_mp4(src_path)

    # -- ffprobe backend --------------------------------------------------

    @staticmethod
    def _from_ffprobe(src_path: str | os.PathLike) -> "VideoInfo":
        # args mirror get_video_stats (ffmpeg_ops.rs:363-377)
        cmd = [
            "ffprobe",
            "-v", "quiet",
            "-show_format",
            "-show_streams",
            "-print_format", "json",
            os.fspath(src_path),
        ]
        from .ffmpeg_harness import (
            FfmpegInternal,
            FfmpegIo,
            FfmpegNotFound,
            run_ffmpeg_command,
        )

        try:
            out = run_ffmpeg_command(
                cmd, timeout_secs=FFPROBE_TIMEOUT_SECS
            )
        except FfmpegInternal as e:
            # nonzero ffprobe exit = no parseable video (keeps the repo's
            # established NotVideo surface; the FfmpegInternal cause, with
            # its truncated stderr, stays chained for diagnosis)
            raise NotVideo() from e
        except (FfmpegNotFound, FfmpegIo):
            raise
        stats = json.loads(out)

        fmt = stats.get("format", {})
        duration = float(fmt.get("duration", "0") or 0.0)
        file_size = int(fmt.get("size", "0") or 0)

        first_video = next(
            (
                s
                for s in stats.get("streams", [])
                if s.get("codec_type") == "video"
            ),
            None,
        )
        width = int((first_video or {}).get("width", 0) or 0)
        height = int((first_video or {}).get("height", 0) or 0)

        # rotation-aware swap (ffmpeg_stats.rs:94-114).  Like the
        # reference (ffmpeg_stats.rs:122 reads side_data_list[0] only),
        # a Display Matrix listed after other side data is missed —
        # mirrored deliberately for parity.
        rotation = 0
        if first_video:
            side = (first_video.get("side_data_list") or [{}])[0]
            raw = side.get("rotation", 0)
            try:
                rotation = int(raw)
            except (TypeError, ValueError):
                rotation = 0
        # Python's % with positive 360 maps negative rotations into
        # 0..359 already (-90 % 360 == 270)
        if rotation % 360 in (90, 270):
            width, height = height, width

        return VideoInfo(duration, file_size, (width, height))

    # -- OpenCV fallback ---------------------------------------------------

    @staticmethod
    def _from_opencv(src_path: str | os.PathLike) -> "VideoInfo":
        import cv2

        path = os.fspath(src_path)
        if not os.path.isfile(path):
            raise NotVideo()
        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise NotVideo()
            fps = cap.get(cv2.CAP_PROP_FPS)
            n = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            if width <= 0 or height <= 0 or n <= 0:
                raise NotVideo()
            duration = float(n) / fps if fps > 0 else 0.0
        finally:
            cap.release()
        return VideoInfo(duration, Path(path).stat().st_size, (width, height))


    # -- gstreamer fallback --------------------------------------------------

    @staticmethod
    def _from_gst(src_path: str | os.PathLike) -> "VideoInfo":
        from . import gst_ctypes

        path = os.fspath(src_path)
        if not os.path.isfile(path) or not gst_ctypes.available():
            raise NotVideo()
        try:
            duration, (w, h), _fps = gst_ctypes.query_media_info(path)
        except Exception:
            raise NotVideo() from None
        if w <= 0 or h <= 0:
            raise NotVideo()
        return VideoInfo(duration, Path(path).stat().st_size, (w, h))


    # -- AV1 mp4 container fallback ------------------------------------------

    @staticmethod
    def _from_av1_mp4(src_path: str | os.PathLike) -> "VideoInfo":
        from . import mp4_av1

        path = os.fspath(src_path)
        if not os.path.isfile(path):
            raise NotVideo()
        try:
            t = mp4_av1.parse_av1_mp4(path)
        except Exception:
            raise NotVideo() from None
        return VideoInfo(
            t.duration, Path(path).stat().st_size, (t.width, t.height)
        )


def is_video_file(src_path: str | os.PathLike) -> bool:
    """codec_type check + duration >= 1 s (ffmpeg_ops.rs:379-421)."""
    try:
        info = VideoInfo.new(src_path)
    except Exception:
        return False
    return info.duration >= 1.0 and info.resolution[0] > 0
