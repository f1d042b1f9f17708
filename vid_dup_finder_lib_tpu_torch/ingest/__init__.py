"""Host-side video ingest: probing and frame decoding.

The hash and search run on the device, but decode stays on host (as in the
reference, where ffmpeg/gstreamer do the decoding).  Backends:

* ``ffmpeg``  — subprocess rawvideo pipe, byte-exact arguments versus the
  reference's ``ffmpeg_cmdline_utils`` crate;
* ``opencv``  — in-process cv2 decode emulating the same fps-resampling
  semantics (used automatically when the ffmpeg binary is absent).
"""

from .backend import (
    FrameReadCfg,
    available_backends,
    get_duration,
    get_resolution,
    is_video_file,
)
from .probe import VideoInfo

__all__ = [
    "FrameReadCfg",
    "VideoInfo",
    "available_backends",
    "get_duration",
    "get_resolution",
    "is_video_file",
]
