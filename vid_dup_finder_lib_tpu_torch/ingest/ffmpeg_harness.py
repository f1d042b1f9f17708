"""Run-to-completion ffmpeg/ffprobe subprocess harness.

Faithful port of the reference's command runner
(``ffmpeg_cmdline_utils/src/ffmpeg_ops.rs:491-596``):

* a watchdog thread bounds total runtime (FFPROBE_TIMEOUT_SECS, 60 s);
* stdout and stderr are drained concurrently while the child runs (so a
  chatty child can never fill a pipe and deadlock);
* on a nonzero exit the stderr text — truncated to its first 500
  characters, ffmpeg error spew can be enormous — becomes the error
  payload, so cached errors stay diagnosable;
* the error taxonomy mirrors the reference's 7-kind ``FfmpegError``
  (``ffmpeg_cmdline_utils/src/ffmpeg_error_kind.rs:9-40``).

The *streaming* frame reader (``ffmpeg_reader.py``) intentionally does
NOT use this: the reference's frame iterator spawns with stderr dropped
(ffmpeg_ops.rs:305-310, "prevent possible lockup") and reads frames
incrementally; this harness is for commands whose whole output is
wanted (ffprobe stats, short decodes).
"""

from __future__ import annotations

import subprocess
import threading
from dataclasses import dataclass, field

from ..errors import VidProc

FFPROBE_TIMEOUT_SECS = 60  # ffmpeg_ops.rs:18
STDERR_TRUNCATE_CHARS = 500  # ffmpeg_ops.rs:496-501


# -- error taxonomy (ffmpeg_error_kind.rs:9-40) -------------------------------


class FfmpegError(VidProc):
    """Base of the ffmpeg subprocess error taxonomy.

    Subclasses ``VidProc`` so the hash cache serializes these like any
    other processing error; ``kind`` round-trips through JSON so a
    cached error keeps its diagnosis.
    """

    def to_json(self) -> dict:
        # store the raw payload (not the formatted Display string) so
        # errors.VdfError.from_json can reconstruct the exact instance
        return {"kind": type(self).__name__, "msg": getattr(self, "msg", "")}


@dataclass
class FfmpegNotFound(FfmpegError):
    """ffmpeg/ffprobe binary not found on PATH."""

    def __post_init__(self) -> None:
        # Exception.__init__ directly: VidProc's dataclass-generated
        # __init__ would re-dispatch to this __post_init__ and recurse
        Exception.__init__(
            self,
            "ffmpeg/ffprobe file not found. Make sure ffmpeg/ffprobe are "
            "installed and visible on the command line",
        )


@dataclass
class FfmpegIo(FfmpegError):
    """IO error while executing the command (includes watchdog timeout,
    mapped from io::ErrorKind::TimedOut exactly like the reference)."""

    msg: str = field(default="")

    def __post_init__(self) -> None:
        Exception.__init__(self, f"Ffmpeg IO error: {self.msg}")


@dataclass
class FfmpegInternal(FfmpegError):
    """Nonzero exit code; carries the first 500 chars of stderr."""

    msg: str = field(default="")

    def __post_init__(self) -> None:
        Exception.__init__(self, f"Internal Ffmpeg Failure: {self.msg}")


@dataclass
class Utf8Conversion(FfmpegError):
    """Command output was not valid UTF-8."""

    def __post_init__(self) -> None:
        Exception.__init__(self, "utf8 parsing/conversion failure")


@dataclass
class InvalidResolution(FfmpegError):
    """ffprobe reported a zero X or Y dimension (often an audio file)."""

    def __post_init__(self) -> None:
        Exception.__init__(self, "Ffmpeg decoded no frames from the video")


@dataclass
class FfmpegInfo(FfmpegError):
    """Failed to obtain video information (VideoInfoError wrapper)."""

    msg: str = field(default="")

    def __post_init__(self) -> None:
        Exception.__init__(self, f"Failed to get video properties: {self.msg}")


@dataclass
class FfmpegOther(FfmpegError):
    msg: str = field(default="")

    def __post_init__(self) -> None:
        Exception.__init__(self, f"Ffmpeg/ffprobe error: {self.msg}")


# -- the harness ---------------------------------------------------------------


def _truncate_stderr(stderr: bytes) -> FfmpegError:
    """ffmpeg_ops.rs:495-501: utf8-decode, keep the first 500 chars."""
    try:
        text = stderr.decode("utf-8")
    except UnicodeDecodeError:
        return Utf8Conversion()
    return FfmpegInternal(text[:STDERR_TRUNCATE_CHARS])


def run_ffmpeg_command(
    args: list[str],
    stderr_null: bool = False,
    timeout_secs: float = FFPROBE_TIMEOUT_SECS,
) -> bytes:
    """Run an ffmpeg/ffprobe command to completion; return its stdout.

    ffmpeg_ops.rs:491-596 semantics: concurrent stdout/stderr drain, a
    watchdog that kills the child after ``timeout_secs`` (surfaced as
    ``FfmpegIo("TimedOut")``, the reference's Io(ErrorKind::TimedOut)
    mapping), ``FfmpegNotFound`` for a missing binary, and
    ``FfmpegInternal`` carrying truncated stderr on a nonzero exit.
    """
    try:
        proc = subprocess.Popen(
            args,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL if stderr_null else subprocess.PIPE,
        )
    except FileNotFoundError as e:
        raise FfmpegNotFound() from e
    except OSError as e:
        raise FfmpegIo(str(e)) from e

    stderr_acc = bytearray()

    def drain_stderr() -> None:
        assert proc.stderr is not None
        while True:
            buf = proc.stderr.read(4096)
            if not buf:
                return
            stderr_acc.extend(buf)

    timed_out = threading.Event()

    def watchdog() -> None:
        try:
            proc.wait(timeout=timeout_secs)
        except subprocess.TimeoutExpired:
            timed_out.set()
            proc.kill()

    drainer = None
    if not stderr_null:
        drainer = threading.Thread(target=drain_stderr, daemon=True)
        drainer.start()
    dog = threading.Thread(target=watchdog, daemon=True)
    dog.start()

    try:
        assert proc.stdout is not None
        if proc.stdin is not None:
            proc.stdin.close()
        stdout = proc.stdout.read()
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    dog.join()
    if drainer is not None:
        drainer.join()

    if timed_out.is_set():
        raise FfmpegIo("TimedOut")
    if proc.returncode != 0:
        raise _truncate_stderr(bytes(stderr_acc))
    return stdout
