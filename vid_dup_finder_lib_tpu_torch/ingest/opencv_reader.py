"""OpenCV in-process frame reader.

Third decode backend (the reference offers gstreamer and ffmpeg-subprocess;
neither is available in some deployments).  Emulates the same resampling
semantics: seek to ``start_offset``, then emit frames at the target fps —
for each output slot ``t_k = start_offset + k * den / num`` the temporally
nearest source frame is taken (gstreamer's ``videorate`` behavior,
``vid_frame_iter/src/frame_iter.rs:59-76``).

Decoding is sequential (``grab``-skipping unneeded frames) because random
seeks are unreliable across containers/codecs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..errors import VidProc


@dataclass
class OpenCvFrameReader:
    src_path: str
    fps: tuple[int, int] | None = None
    start_offset: float = 0.0
    num_frames: int | None = None
    grayscale: bool = True

    def frames(self) -> Iterator[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(self.src_path)
        try:
            if not cap.isOpened():
                raise VidProc(f"cannot open {self.src_path}")
            src_fps = cap.get(cv2.CAP_PROP_FPS)
            n_src = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if src_fps <= 0 or n_src <= 0:
                raise VidProc(f"no decodable frames in {self.src_path}")

            # Source frame indices to emit.
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

            pos = 0
            want_iter = iter(wanted)
            nxt = next(want_iter)
            while True:
                if not cap.grab():
                    break
                if pos == nxt:
                    ok, img = cap.retrieve()
                    if not ok:
                        break
                    if self.grayscale:
                        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                    else:
                        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                    frame = np.asarray(img)
                    # a source frame may satisfy several output slots
                    # (videorate duplicates when upsampling)
                    while nxt is not None and nxt <= pos:
                        yield frame
                        try:
                            nxt = next(want_iter)
                        except StopIteration:
                            nxt = None
                    if nxt is None:
                        return
                pos += 1
        finally:
            cap.release()
