"""ffmpeg-subprocess frame reader.

Byte-exact port of the reference's rawvideo pipe reader
(``ffmpeg_cmdline_utils/src/ffmpeg_ops.rs:199-331``): spawns

    ffmpeg -hide_banner -loglevel warning -nostats [-threads 1]
           [-ss SKIP] -i SRC [-vf fps=NUM/DEN] [-vframes N]
           -pix_fmt gray|rgb24 -c:v rawvideo -f image2pipe -

and parses fixed-size raw frames off stdout, with the reference's
safety rails: wall-clock timeout, memory guard, child reaping.
"""

from __future__ import annotations

import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..errors import VidProc
from .probe import VideoInfo

# ffmpeg_ops.rs:32-61 — stop decoding if a frame stream would exceed 5 GB.
MAX_STREAM_BYTES = 5 * 2**30


@dataclass
class FfmpegFrameReader:
    src_path: str
    fps: tuple[int, int] | None = None  # (num, den)
    skip_forward: int | None = None  # whole seconds (facade casts f64 as u32)
    num_frames: int | None = None
    grayscale: bool = True
    multithreaded: bool = False
    timeout_secs: float | None = None

    def _args(self) -> list[str]:
        args = ["ffmpeg", "-hide_banner", "-loglevel", "warning", "-nostats"]
        if not self.multithreaded:
            args += ["-threads", "1"]
        if self.skip_forward is not None:
            args += ["-ss", str(self.skip_forward)]
        args += ["-i", self.src_path]
        if self.fps is not None:
            args += ["-vf", f"fps={self.fps[0]}/{self.fps[1]}"]
        if self.num_frames is not None:
            args += ["-vframes", str(self.num_frames)]
        args += ["-pix_fmt", "gray" if self.grayscale else "rgb24"]
        args += ["-c:v", "rawvideo", "-f", "image2pipe", "-"]
        return args

    def frames(self) -> Iterator[np.ndarray]:
        """Yield frames as u8 [H, W] (gray) or [H, W, 3] (rgb)."""
        info = VideoInfo.new(self.src_path)
        w, h = info.resolution
        if w == 0 or h == 0:
            # ffmpeg_ops.rs:203-207 -> FfmpegError::InvalidResolution
            from .ffmpeg_harness import InvalidResolution

            raise InvalidResolution()
        frame_bytes = w * h * (1 if self.grayscale else 3)

        proc = subprocess.Popen(
            self._args(),
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,  # reference drops stderr to avoid lockup
        )
        deadline = (
            time.monotonic() + self.timeout_secs if self.timeout_secs else None
        )
        # watchdog: the deadline check below only runs between frames, so a
        # child that hangs mid-frame would block read() forever — the timer
        # kills it at the deadline, turning the hang into an EOF we can
        # diagnose (the reference's frame iter has the same between-frames
        # check; the kill-timer is the run-harness watchdog applied here).
        watchdog = None
        if self.timeout_secs:
            watchdog = threading.Timer(self.timeout_secs, proc.kill)
            watchdog.daemon = True
            watchdog.start()
        read_total = 0
        try:
            assert proc.stdout is not None
            while True:
                if deadline is not None and time.monotonic() > deadline:
                    raise VidProc("ffmpeg frame read timed out")
                buf = proc.stdout.read(frame_bytes)
                if not buf:
                    if deadline is not None and time.monotonic() > deadline:
                        raise VidProc("ffmpeg frame read timed out")
                    break
                while len(buf) < frame_bytes:
                    more = proc.stdout.read(frame_bytes - len(buf))
                    if not more:
                        break
                    buf += more
                if len(buf) < frame_bytes:
                    if deadline is not None and time.monotonic() > deadline:
                        raise VidProc("ffmpeg frame read timed out")
                    break  # truncated trailing frame
                read_total += frame_bytes
                if read_total > MAX_STREAM_BYTES:
                    raise VidProc("frame stream exceeded memory guard")
                arr = np.frombuffer(buf, dtype=np.uint8)
                yield (
                    arr.reshape(h, w)
                    if self.grayscale
                    else arr.reshape(h, w, 3)
                )
        finally:
            if watchdog is not None:
                watchdog.cancel()
            # reap the child to avoid zombies (ffmpeg_ops.rs:107-112)
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def ffmpeg_available() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None
