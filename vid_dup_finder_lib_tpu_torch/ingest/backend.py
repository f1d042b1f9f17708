"""Decode-backend facade.

Runtime-selectable equivalent of the reference's compile-time backend switch
(``ffmpeg_gst_wrapper/src/lib.rs:76-271``): a ``FrameReadCfg`` carries
(src_path, fps fraction, start_offset) and spawns a gray/RGB frame iterator
from whichever backend is available — ffmpeg subprocess preferred (reference
semantics), OpenCV in-process otherwise.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ..errors import NotVideo, VidProc
from .ffmpeg_reader import FfmpegFrameReader, ffmpeg_available
from .opencv_reader import OpenCvFrameReader
from .probe import VideoInfo


def available_backends() -> list[str]:
    """Usable decode backends, preferred first.

    gstreamer-via-PyGObject leads (the reference's default backend — a
    ``gi`` install implies a full distro plugin set); gstreamer via the
    direct ctypes binding (``gst_ctypes.py``) is listed LAST because
    minimal images ship only the base plugin set (no mp4/h264 demux
    here), so it is a fallback / explicit ``force_backend`` choice
    rather than the auto default.
    """
    out = []
    from .gstreamer_reader import available_kind as gst_kind

    kind = gst_kind()
    if kind == "gi":
        out.append("gstreamer")  # reference's default backend
    if ffmpeg_available():
        out.append("ffmpeg")
    try:
        import cv2  # noqa: F401

        out.append("opencv")
    except ImportError:
        pass
    if kind == "ctypes":
        out.append("gstreamer")
    return out


_FORCED_BACKEND: str | None = None


def force_backend(name: str | None) -> None:
    """Test/CLI hook: pin the decode backend ('ffmpeg' | 'opencv' | None)."""
    global _FORCED_BACKEND
    _FORCED_BACKEND = name


def _pick_backend() -> str:
    if _FORCED_BACKEND:
        return _FORCED_BACKEND
    avail = available_backends()
    if not avail:
        raise VidProc("no decode backend available (need ffmpeg or OpenCV)")
    return avail[0]


def active_backend_name() -> str:
    """The backend decodes will actually use (honors ``force_backend``) —
    what hash-affecting metadata (the cache sidecar) must record."""
    try:
        return _pick_backend()
    except VidProc:
        return "none"


@dataclass
class FrameReadCfg:
    """(ffmpeg_gst_wrapper/src/lib.rs:76-81)"""

    src_path: str
    fps: tuple[int, int] | None = None
    start_offset: float | None = None
    backend: str | None = field(default=None)

    @staticmethod
    def from_path(src_path: str | os.PathLike) -> "FrameReadCfg":
        return FrameReadCfg(os.fspath(src_path))

    def set_fps(self, fps: tuple[int, int]) -> None:
        self.fps = fps

    def set_start_offset(self, offset: float) -> None:
        self.start_offset = offset

    def spawn_gray(self) -> Iterator[np.ndarray]:
        return self._spawn(grayscale=True)

    def spawn_rgb(self) -> Iterator[np.ndarray]:
        return self._spawn(grayscale=False)

    def _spawn(self, grayscale: bool) -> Iterator[np.ndarray]:
        backend = self.backend or _pick_backend()
        if backend == "gstreamer":
            from .gstreamer_reader import GStreamerFrameReader

            reader = GStreamerFrameReader(
                self.src_path,
                fps=self.fps,
                start_offset=self.start_offset or 0.0,
                grayscale=grayscale,
            )
        elif backend == "ffmpeg":
            # facade casts the f64 offset to u32 whole seconds
            # (ffmpeg_gst_wrapper/src/lib.rs:201-203)
            reader = FfmpegFrameReader(
                self.src_path,
                fps=self.fps,
                skip_forward=(
                    int(self.start_offset)
                    if self.start_offset is not None
                    else None
                ),
                grayscale=grayscale,
            )
        elif backend == "opencv":
            # AV1-in-mp4 delegation: OpenCV's bundled ffmpeg has no AV1
            # software decoder (the reference's bundled cat.2/dog.2 fail
            # with a hardware-accel error), but libdav1d can — sniff and
            # route so AV1 ingest needs no configuration
            from . import av1_reader

            if av1_reader.can_read(self.src_path):
                reader = av1_reader.Av1FrameReader(
                    self.src_path,
                    fps=self.fps,
                    start_offset=self.start_offset or 0.0,
                    grayscale=grayscale,
                )
            else:
                reader = OpenCvFrameReader(
                    self.src_path,
                    fps=self.fps,
                    start_offset=self.start_offset or 0.0,
                    grayscale=grayscale,
                )
        else:
            raise VidProc(f"unknown decode backend {backend!r}")
        return reader.frames()


def get_duration(src_path: str | os.PathLike) -> float:
    """Video duration in (fractional) seconds; raises NotVideo on failure
    (ffmpeg_gst_wrapper/src/lib.rs:66-74)."""
    info = VideoInfo.new(src_path)
    if info.duration <= 0:
        raise NotVideo()
    return info.duration


def get_resolution(src_path: str | os.PathLike) -> tuple[int, int]:
    return VideoInfo.new(src_path).resolution


def is_video_file(src_path: str | os.PathLike) -> bool:
    from .probe import is_video_file as _ivf

    return _ivf(src_path)
