"""AV1 frame reader: mp4 demux (``mp4_av1``) + dav1d decode
(``dav1d_ctypes``).

Compatibility reader for AV1-in-mp4 files that no other backend in this
image can decode (the reference's bundled cat.2/dog.2,
``examples/obtain_videos.sh:24``).  Resampling semantics are IDENTICAL
to ``OpenCvFrameReader``: for each output slot
``t_k = start_offset + k * den / num`` the temporally nearest source
frame index is emitted, duplicating when upsampling (gstreamer
``videorate`` behavior, ``vid_frame_iter/src/frame_iter.rs:59-76``).

The OpenCV backend delegates here automatically when a file sniffs as
AV1-in-mp4 and dav1d is available (``backend._spawn``), so
``VideoHashBuilder`` and the CLI ingest AV1 with no configuration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..errors import VidProc
from . import dav1d_ctypes, mp4_av1


def can_read(src_path: str) -> bool:
    """True when this file is AV1-in-mp4 and dav1d is loadable."""
    return dav1d_ctypes.available() and mp4_av1.is_av1_mp4(src_path)


@dataclass
class Av1FrameReader:
    src_path: str
    fps: tuple[int, int] | None = None
    start_offset: float = 0.0
    num_frames: int | None = None
    grayscale: bool = True

    def frames(self) -> Iterator[np.ndarray]:
        track = mp4_av1.parse_av1_mp4(self.src_path)
        src_fps = track.fps
        n_src = track.n_samples
        if src_fps <= 0 or n_src <= 0:
            raise VidProc(f"no decodable frames in {self.src_path}")

        # identical slot selection to OpenCvFrameReader.frames
        if self.fps is None:
            first = int(round(self.start_offset * src_fps))
            wanted = list(range(first, n_src))
        else:
            num, den = self.fps
            out_dt = den / num
            wanted = []
            k = 0
            while True:
                t = self.start_offset + k * out_dt
                idx = int(round(t * src_fps))
                if idx >= n_src:
                    break
                wanted.append(min(idx, n_src - 1))
                k += 1
                if self.num_frames is not None and k >= self.num_frames:
                    break
        if self.num_frames is not None:
            wanted = wanted[: self.num_frames]
        if not wanted:
            return

        last_needed = wanted[-1]
        with open(self.src_path, "rb") as fh:

            def samples():
                for off, size in track.sample_spans[: last_needed + 1]:
                    fh.seek(off)
                    yield fh.read(size)

            want_iter = iter(wanted)
            nxt = next(want_iter)
            pos = 0
            for frame in dav1d_ctypes.decode_frames(
                samples(),
                expect_w=track.width,
                expect_h=track.height,
                grayscale=self.grayscale,
            ):
                if pos == nxt:
                    while nxt is not None and nxt <= pos:
                        yield frame
                        try:
                            nxt = next(want_iter)
                        except StopIteration:
                            nxt = None
                    if nxt is None:
                        return
                pos += 1
