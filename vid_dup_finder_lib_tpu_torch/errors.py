"""Error types for hash creation.

Mirrors the reference's serializable error enum
(``vid_dup_finder_lib/src/video_hashing/mod.rs:17-28``): errors are values that
can be stored in the hash cache so a failing video is not re-decoded each run.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class VdfError(Exception):
    """Base class for all framework errors."""

    def to_json(self) -> dict:
        return {"kind": type(self).__name__, "msg": str(self)}

    @staticmethod
    def from_json(obj: dict) -> "VdfError":
        kind = obj.get("kind")
        msg = obj.get("msg", "")
        if kind == "NotVideo":
            return NotVideo()
        if kind == "NotEnoughFrames":
            return NotEnoughFrames()
        if kind in _FFMPEG_KINDS:
            # 7-kind ffmpeg taxonomy (ffmpeg_error_kind.rs:9-40): cached
            # errors keep their diagnosis across cache round-trips
            from .ingest import ffmpeg_harness as fh

            cls = getattr(fh, kind)
            try:
                return cls(msg) if _FFMPEG_KINDS[kind] else cls()
            except TypeError:
                pass
        return VidProc(msg)


# kind name -> takes a message payload
_FFMPEG_KINDS = {
    "FfmpegNotFound": False,
    "FfmpegIo": True,
    "FfmpegInternal": True,
    "Utf8Conversion": False,
    "InvalidResolution": False,
    "FfmpegInfo": True,
    "FfmpegOther": True,
}


@dataclass
class NotVideo(VdfError):
    """The file is not a video (ffprobe found no video stream)."""

    def __post_init__(self) -> None:
        super().__init__("not a video file")


@dataclass
class VidProc(VdfError):
    """An error occurred while processing the video."""

    msg: str = field(default="")

    def __post_init__(self) -> None:
        super().__init__(self.msg)


@dataclass
class NotEnoughFrames(VdfError):
    """Fewer than DCT_SIZE frames could be decoded."""

    def __post_init__(self) -> None:
        super().__init__("video file does not contain enough frames")
