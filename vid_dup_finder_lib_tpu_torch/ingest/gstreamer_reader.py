"""GStreamer in-process frame reader (optional backend).

Equivalent of the reference's primary decode backend
(``vid_frame_iter/src/frame_iter.rs:59-347``): a
``uridecodebin ! videorate ! capsfilter ! videoconvert ! appsink``
pipeline with accurate seeking and fps resampling.  Two bindings, same
semantics:

* PyGObject (``gi``) when installed — the full-desktop path;
* a direct ctypes binding to the gst C libraries otherwise
  (``gst_ctypes.py`` — the same libraries the reference binds via
  gstreamer-rs), which makes this backend LIVE on images that ship
  libgstreamer without Python bindings (like this CI image; live-path
  tests in ``tests/test_gstreamer_live.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..errors import VidProc

SAMPLE_TIMEOUT_SECS = 30  # frame_iter.rs:239 pull timeout


def _gi_available() -> bool:
    try:
        import gi

        gi.require_version("Gst", "1.0")
        from gi.repository import Gst  # noqa: F401

        return True
    except Exception:
        return False


def available_kind() -> str | None:
    """Which binding the gstreamer backend would use: 'gi' | 'ctypes'."""
    if _gi_available():
        return "gi"
    from . import gst_ctypes

    if gst_ctypes.available():
        return "ctypes"
    return None


def available() -> bool:
    return available_kind() is not None


@dataclass
class GStreamerFrameReader:
    src_path: str
    fps: tuple[int, int] | None = None
    start_offset: float = 0.0
    grayscale: bool = True

    def frames(self) -> Iterator[np.ndarray]:
        kind = available_kind()
        if kind is None:
            raise VidProc(
                "gstreamer backend unavailable (no PyGObject and the "
                "gst C libraries did not load)"
            )
        if kind == "ctypes":
            from .gst_ctypes import GstCtypesFrameReader

            yield from GstCtypesFrameReader(
                self.src_path,
                fps=self.fps,
                start_offset=self.start_offset,
                grayscale=self.grayscale,
            ).frames()
            return
        import gi

        gi.require_version("Gst", "1.0")
        from gi.repository import Gst

        Gst.init(None)
        fmt = "GRAY8" if self.grayscale else "RGB"
        rate = (
            f",framerate={self.fps[0]}/{self.fps[1]}" if self.fps else ""
        )
        from pathlib import Path

        # percent-encoded absolute file URI: raw concatenation split the
        # parse_launch string at spaces in the path and produced invalid
        # URIs for relative paths
        uri = Path(self.src_path).absolute().as_uri()
        pipeline = Gst.parse_launch(
            f"uridecodebin uri={uri} buffer-size=1 ! "
            f"videorate ! capsfilter caps=video/x-raw{rate} ! "
            "videoconvert ! appsink name=sink sync=false max-buffers=1 "
            f"caps=video/x-raw,format={fmt}"
        )
        sink = pipeline.get_by_name("sink")
        pipeline.set_state(Gst.State.PAUSED)
        pipeline.get_state(Gst.CLOCK_TIME_NONE)
        if self.start_offset > 0:
            pipeline.seek_simple(
                Gst.Format.TIME,
                Gst.SeekFlags.ACCURATE | Gst.SeekFlags.FLUSH,
                int(self.start_offset * Gst.SECOND),
            )
        pipeline.set_state(Gst.State.PLAYING)
        try:
            while True:
                sample = sink.emit(
                    "try-pull-sample", SAMPLE_TIMEOUT_SECS * Gst.SECOND
                )
                if sample is None:
                    break
                buf = sample.get_buffer()
                caps = sample.get_caps().get_structure(0)
                w = caps.get_value("width")
                h = caps.get_value("height")
                ok, info = buf.map(Gst.MapFlags.READ)
                if not ok:
                    raise VidProc("gst buffer map failed")
                try:
                    data = np.frombuffer(info.data, dtype=np.uint8)
                    if self.grayscale:
                        stride = len(data) // h
                        yield data.reshape(h, stride)[:, :w].copy()
                    else:
                        stride = len(data) // h
                        yield (
                            data.reshape(h, stride)[:, : w * 3]
                            .reshape(h, w, 3)
                            .copy()
                        )
                finally:
                    buf.unmap(info)
        finally:
            pipeline.set_state(Gst.State.NULL)  # frame_iter.rs:335-347
