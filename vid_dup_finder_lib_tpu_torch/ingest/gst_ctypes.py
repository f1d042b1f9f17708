"""Direct ctypes binding to the GStreamer C libraries (no PyGObject).

The reference's primary decode backend is gstreamer bound natively via
gstreamer-rs (``vid_frame_iter/src/frame_iter.rs:59-347``,
``vid_frame_iter/Cargo.toml:14-19``).  This module is the same idea for
this framework: a minimal, stable-ABI ctypes binding to
``libgstreamer-1.0`` / ``libgstapp-1.0`` that makes the gstreamer
backend LIVE even where the PyGObject (``gi``) bindings are not
installed — e.g. this CI image, which ships the gst C libraries and the
base plugin set but no ``gi``.

Scope: exactly what the frame reader needs — ``gst_parse_launch``
pipelines, state changes with preroll waits, accurate flushing seeks,
``appsink`` sample pulls with timeout, bus error draining, and
guaranteed teardown (``frame_iter.rs:230-347`` semantics).  Everything
else (duration probing, stream statistics) stays on the ffprobe/OpenCV
probe path.

Safety notes:

* ``GstMapInfo`` and ``GError`` are fixed public ABI structs; the one
  struct-offset this module does NOT hardcode is ``GstMessage.type``,
  which is discovered at init by scanning a freshly created
  known-type message (``_find_message_type_offset``) and verified
  against a second message type — version-proof without GObject
  introspection.
* ctypes ``CDLL`` calls release the GIL, so gstreamer's streaming
  threads run freely while Python blocks in ``try_pull_sample``.
"""

from __future__ import annotations

import ctypes as C
import os
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

from ..errors import VidProc

SAMPLE_TIMEOUT_SECS = 30  # frame_iter.rs:239 pull timeout
PREROLL_TIMEOUT_SECS = 30  # bounded (gi path uses CLOCK_TIME_NONE)

GST_SECOND = 1_000_000_000
_CLOCK_TIME_NONE = 2**64 - 1

# GstState
_STATE_NULL, _STATE_PAUSED, _STATE_PLAYING = 1, 3, 4
# GstStateChangeReturn
_STATE_CHANGE_FAILURE = 0
# GstFormat.TIME
_FORMAT_TIME = 3
# GstSeekFlags
_SEEK_FLUSH, _SEEK_ACCURATE = 1 << 0, 1 << 1
# GstMessageType
_MSG_EOS, _MSG_ERROR = 1 << 0, 1 << 1
# GstMapFlags
_MAP_READ = 1


class _GError(C.Structure):
    _fields_ = [
        ("domain", C.c_uint32),
        ("code", C.c_int),
        ("message", C.c_char_p),
    ]


class _GstMapInfo(C.Structure):
    _fields_ = [
        ("memory", C.c_void_p),
        ("flags", C.c_int),
        ("data", C.c_void_p),
        ("size", C.c_size_t),
        ("maxsize", C.c_size_t),
        ("user_data", C.c_void_p * 4),
        ("_gst_reserved", C.c_void_p * 4),
    ]


class _Lib:
    """Bound C entry points + the discovered GstMessage.type offset."""

    def __init__(self) -> None:
        self.gst = C.CDLL("libgstreamer-1.0.so.0")
        self.app = C.CDLL("libgstapp-1.0.so.0")
        try:
            self.glib = C.CDLL("libglib-2.0.so.0")
        except OSError:  # gst links glib; should not happen
            self.glib = None

        def p(fn, restype, argtypes):
            fn.restype = restype
            fn.argtypes = argtypes
            return fn

        g = self.gst
        self.init_check = p(g.gst_init_check, C.c_int, [C.c_void_p] * 3)
        self.parse_launch = p(
            g.gst_parse_launch,
            C.c_void_p,
            [C.c_char_p, C.POINTER(C.POINTER(_GError))],
        )
        self.factory_find = p(
            g.gst_element_factory_find, C.c_void_p, [C.c_char_p]
        )
        self.set_state = p(
            g.gst_element_set_state, C.c_int, [C.c_void_p, C.c_int]
        )
        self.get_state = p(
            g.gst_element_get_state,
            C.c_int,
            [C.c_void_p, C.c_void_p, C.c_void_p, C.c_uint64],
        )
        self.bin_get_by_name = p(
            g.gst_bin_get_by_name, C.c_void_p, [C.c_void_p, C.c_char_p]
        )
        self.seek_simple = p(
            g.gst_element_seek_simple,
            C.c_int,
            [C.c_void_p, C.c_int, C.c_int, C.c_int64],
        )
        self.query_duration = p(
            g.gst_element_query_duration,
            C.c_int,
            [C.c_void_p, C.c_int, C.POINTER(C.c_int64)],
        )
        self.get_bus = p(g.gst_element_get_bus, C.c_void_p, [C.c_void_p])
        self.bus_pop_filtered = p(
            g.gst_bus_pop_filtered, C.c_void_p, [C.c_void_p, C.c_int]
        )
        self.bus_timed_pop_filtered = p(
            g.gst_bus_timed_pop_filtered,
            C.c_void_p,
            [C.c_void_p, C.c_uint64, C.c_int],
        )
        self.message_parse_error = p(
            g.gst_message_parse_error,
            None,
            [
                C.c_void_p,
                C.POINTER(C.POINTER(_GError)),
                C.POINTER(C.c_char_p),
            ],
        )
        self.message_new_eos = p(
            g.gst_message_new_eos, C.c_void_p, [C.c_void_p]
        )
        self.message_new_latency = p(
            g.gst_message_new_latency, C.c_void_p, [C.c_void_p]
        )
        self.mini_object_unref = p(
            g.gst_mini_object_unref, None, [C.c_void_p]
        )
        self.object_unref = p(g.gst_object_unref, None, [C.c_void_p])
        self.sample_get_buffer = p(
            g.gst_sample_get_buffer, C.c_void_p, [C.c_void_p]
        )
        self.sample_get_caps = p(
            g.gst_sample_get_caps, C.c_void_p, [C.c_void_p]
        )
        self.caps_get_structure = p(
            g.gst_caps_get_structure, C.c_void_p, [C.c_void_p, C.c_uint]
        )
        self.structure_get_int = p(
            g.gst_structure_get_int,
            C.c_int,
            [C.c_void_p, C.c_char_p, C.POINTER(C.c_int)],
        )
        self.buffer_map = p(
            g.gst_buffer_map,
            C.c_int,
            [C.c_void_p, C.POINTER(_GstMapInfo), C.c_int],
        )
        self.buffer_unmap = p(
            g.gst_buffer_unmap, None, [C.c_void_p, C.POINTER(_GstMapInfo)]
        )
        self.try_pull_sample = p(
            self.app.gst_app_sink_try_pull_sample,
            C.c_void_p,
            [C.c_void_p, C.c_uint64],
        )
        self.try_pull_preroll = p(
            self.app.gst_app_sink_try_pull_preroll,
            C.c_void_p,
            [C.c_void_p, C.c_uint64],
        )
        self.structure_get_fraction = p(
            g.gst_structure_get_fraction,
            C.c_int,
            [
                C.c_void_p,
                C.c_char_p,
                C.POINTER(C.c_int),
                C.POINTER(C.c_int),
            ],
        )
        if self.glib is not None:
            self.g_error_free = p(
                self.glib.g_error_free, None, [C.c_void_p]
            )
            self.g_free = p(self.glib.g_free, None, [C.c_void_p])
        else:  # pragma: no cover - glib always present beside gst
            self.g_error_free = lambda e: None
            self.g_free = lambda s: None

        if not self.init_check(None, None, None):
            raise OSError("gst_init_check failed")
        self.msg_type_offset = self._find_message_type_offset()

    def _find_message_type_offset(self) -> int:
        """Locate ``GstMessage.type`` without hardcoding the struct.

        Creates a LATENCY message (type value ``1 << 19`` — unique, so
        it cannot collide with a refcount of 1 the way EOS' value would)
        and scans the first 128 bytes for it, then verifies the found
        offset reads EOS' value from an EOS message.
        """
        latency_val = 1 << 19
        msg = self.message_new_latency(None)
        raw = C.string_at(msg, 128)
        offsets = [
            off
            for off in range(0, 124, 4)
            if int.from_bytes(raw[off : off + 4], "little") == latency_val
        ]
        self.mini_object_unref(msg)
        eos = self.message_new_eos(None)
        raw = C.string_at(eos, 128)
        offsets = [
            off
            for off in offsets
            if int.from_bytes(raw[off : off + 4], "little") == _MSG_EOS
        ]
        self.mini_object_unref(eos)
        if len(offsets) != 1:
            raise OSError(
                f"could not locate GstMessage.type (candidates {offsets})"
            )
        return offsets[0]

    def message_type(self, msg) -> int:
        return int.from_bytes(
            C.string_at(msg + self.msg_type_offset, 4), "little"
        )

    def pop_error_text(self, bus) -> str | None:
        """Drain the bus' first pending ERROR message into text."""
        msg = self.bus_pop_filtered(bus, _MSG_ERROR)
        if not msg:
            return None
        err = C.POINTER(_GError)()
        dbg = C.c_char_p()
        self.message_parse_error(msg, C.byref(err), C.byref(dbg))
        text = "gstreamer error"
        if err:
            text = (err.contents.message or b"?").decode(
                "utf-8", "replace"
            )
            self.g_error_free(err)
        if dbg.value is not None:
            # truncated like the ffmpeg harness truncates stderr
            text += f" [{dbg.value[:500].decode('utf-8', 'replace')}]"
            self.g_free(dbg)
        self.mini_object_unref(msg)
        return text


_LIB: _Lib | None = None
_LIB_ERR: Exception | None = None
_LOCK = threading.Lock()

_REQUIRED_ELEMENTS = (
    b"uridecodebin",
    b"videorate",
    b"capsfilter",
    b"videoconvert",
    b"appsink",
)


def _lib() -> _Lib | None:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            if os.environ.get("VDF_GST_CTYPES", "1") != "1":
                _LIB_ERR = RuntimeError("disabled via VDF_GST_CTYPES=0")
                return None
            try:
                lib = _Lib()
                for el in _REQUIRED_ELEMENTS:
                    f = lib.factory_find(el)
                    if not f:
                        raise OSError(f"gst element {el!r} missing")
                    lib.object_unref(f)
                _LIB = lib
            except Exception as e:  # no gst libs / broken install
                _LIB_ERR = e
    return _LIB


def available() -> bool:
    """True when the gst C libraries load and the pipeline elements exist."""
    return _lib() is not None


def has_element(name: str) -> bool:
    lib = _lib()
    if lib is None:
        return False
    f = lib.factory_find(name.encode())
    if not f:
        return False
    lib.object_unref(f)
    return True


def run_pipeline_to_eos(
    description: str, timeout_secs: float = 60.0
) -> None:
    """Run a parse_launch pipeline until EOS (or raise on error/timeout).

    Used by tests to synthesize real video files from ``videotestsrc``
    (the reference's bundled-video role) with whatever encoder elements
    the image provides.
    """
    lib = _lib()
    if lib is None:
        raise VidProc("gstreamer ctypes backend unavailable")
    err = C.POINTER(_GError)()
    pipe = lib.parse_launch(description.encode(), C.byref(err))
    if not pipe:
        text = "parse_launch failed"
        if err:
            text = (err.contents.message or b"?").decode("utf-8", "replace")
            lib.g_error_free(err)
        raise VidProc(f"gst pipeline: {text}")
    bus = lib.get_bus(pipe)
    try:
        if (
            lib.set_state(pipe, _STATE_PLAYING) == _STATE_CHANGE_FAILURE
        ):  # pragma: no cover - parse_launch already validated
            raise VidProc(lib.pop_error_text(bus) or "gst PLAYING failed")
        msg = lib.bus_timed_pop_filtered(
            bus, int(timeout_secs * GST_SECOND), _MSG_EOS | _MSG_ERROR
        )
        if not msg:
            raise VidProc(f"gst pipeline: no EOS within {timeout_secs}s")
        kind = lib.message_type(msg)
        lib.mini_object_unref(msg)
        if kind == _MSG_ERROR:
            raise VidProc(
                lib.pop_error_text(bus) or "gst pipeline error"
            )
    finally:
        lib.set_state(pipe, _STATE_NULL)
        lib.object_unref(bus)
        lib.object_unref(pipe)


def query_media_info(
    src_path: str | os.PathLike,
) -> tuple[float, tuple[int, int], float]:
    """(duration_secs, (width, height), fps) via a PAUSED preroll.

    The gst equivalent of the reference's Discoverer-based
    ``mediainfo_utils::{duration,dimensions,frame_rate}``
    (``vid_frame_iter/src/mediainfo_utils.rs:13-68``) — makes the
    gstreamer backend self-contained for metadata (no ffprobe/OpenCV
    needed).  Raises ``VidProc`` when the file cannot preroll (not a
    video / no matching demuxer).  Duration may be 0.0 when the
    container does not report one; rotation-tag dimension swap is an
    ffprobe-tier feature only.
    """
    lib = _lib()
    if lib is None:
        raise VidProc("gstreamer ctypes backend unavailable")
    uri = Path(os.fspath(src_path)).absolute().as_uri()
    desc = (
        f"uridecodebin uri={uri} ! videoconvert ! "
        "appsink name=sink sync=false max-buffers=1 "
        "caps=video/x-raw,format=GRAY8"
    )
    err = C.POINTER(_GError)()
    pipe = lib.parse_launch(desc.encode(), C.byref(err))
    if not pipe:
        if err:
            lib.g_error_free(err)
        raise VidProc("gst pipeline: parse_launch failed")
    sink = lib.bin_get_by_name(pipe, b"sink")
    bus = lib.get_bus(pipe)
    try:
        if (
            lib.set_state(pipe, _STATE_PAUSED) == _STATE_CHANGE_FAILURE
            or lib.get_state(
                pipe, None, None, PREROLL_TIMEOUT_SECS * GST_SECOND
            )
            == _STATE_CHANGE_FAILURE
        ):
            raise VidProc(
                lib.pop_error_text(bus) or "gst preroll failed"
            )
        sample = lib.try_pull_preroll(
            sink, SAMPLE_TIMEOUT_SECS * GST_SECOND
        )
        if not sample:
            raise VidProc(
                lib.pop_error_text(bus) or "gst preroll: no sample"
            )
        try:
            st = lib.caps_get_structure(lib.sample_get_caps(sample), 0)
            w = C.c_int()
            h = C.c_int()
            if not (
                lib.structure_get_int(st, b"width", C.byref(w))
                and lib.structure_get_int(st, b"height", C.byref(h))
            ):
                raise VidProc("gst caps missing dimensions")
            num = C.c_int()
            den = C.c_int()
            fps = (
                num.value / den.value
                if lib.structure_get_fraction(
                    st, b"framerate", C.byref(num), C.byref(den)
                )
                and den.value
                else 0.0
            )
        finally:
            lib.mini_object_unref(sample)
        dur = C.c_int64(-1)
        ok = lib.query_duration(pipe, _FORMAT_TIME, C.byref(dur))
        duration = (
            dur.value / GST_SECOND if ok and dur.value >= 0 else 0.0
        )
        return duration, (w.value, h.value), fps
    finally:
        lib.set_state(pipe, _STATE_NULL)
        if sink:
            lib.object_unref(sink)
        lib.object_unref(bus)
        lib.object_unref(pipe)


@dataclass
class GstCtypesFrameReader:
    """Same contract as ``GStreamerFrameReader``, bound via ctypes.

    Pipeline, seek, pull and teardown semantics mirror the reference's
    ``VideoFrameIter`` (``frame_iter.rs:59-114`` build+seek,
    ``:230-301`` pull loop with 30 s timeout and bus-error drain,
    ``:335-347`` guaranteed transition to Null).
    """

    src_path: str
    fps: tuple[int, int] | None = None
    start_offset: float = 0.0
    grayscale: bool = True

    def frames(self) -> Iterator[np.ndarray]:
        lib = _lib()
        if lib is None:
            raise VidProc("gstreamer ctypes backend unavailable")
        fmt = "GRAY8" if self.grayscale else "RGB"
        rate = (
            f",framerate={self.fps[0]}/{self.fps[1]}" if self.fps else ""
        )
        uri = Path(self.src_path).absolute().as_uri()
        desc = (
            f"uridecodebin uri={uri} buffer-size=1 ! "
            f"videorate ! capsfilter caps=video/x-raw{rate} ! "
            "videoconvert ! appsink name=sink sync=false max-buffers=1 "
            f"caps=video/x-raw,format={fmt}"
        )
        err = C.POINTER(_GError)()
        pipe = lib.parse_launch(desc.encode(), C.byref(err))
        if not pipe:
            text = "parse_launch failed"
            if err:
                text = (err.contents.message or b"?").decode(
                    "utf-8", "replace"
                )
                lib.g_error_free(err)
            raise VidProc(f"gst pipeline: {text}")
        sink = lib.bin_get_by_name(pipe, b"sink")
        bus = lib.get_bus(pipe)
        try:
            if not sink:  # pragma: no cover - sink is in the description
                raise VidProc("gst pipeline: appsink missing")
            # preroll in PAUSED so the seek lands before any frame flows
            # (frame_iter.rs:101-114)
            if (
                lib.set_state(pipe, _STATE_PAUSED)
                == _STATE_CHANGE_FAILURE
            ):
                raise VidProc(
                    lib.pop_error_text(bus) or "gst PAUSED failed"
                )
            ret = lib.get_state(
                pipe, None, None, PREROLL_TIMEOUT_SECS * GST_SECOND
            )
            if ret == _STATE_CHANGE_FAILURE:
                raise VidProc(
                    lib.pop_error_text(bus) or "gst preroll failed"
                )
            if self.start_offset > 0:
                if not lib.seek_simple(
                    pipe,
                    _FORMAT_TIME,
                    _SEEK_ACCURATE | _SEEK_FLUSH,
                    int(self.start_offset * GST_SECOND),
                ):
                    raise VidProc("gst seek failed")  # frame_iter.rs:314-323
            if (
                lib.set_state(pipe, _STATE_PLAYING)
                == _STATE_CHANGE_FAILURE
            ):  # pragma: no cover - preroll above already succeeded
                raise VidProc(
                    lib.pop_error_text(bus) or "gst PLAYING failed"
                )
            w = C.c_int()
            h = C.c_int()
            info = _GstMapInfo()
            while True:
                sample = lib.try_pull_sample(
                    sink, SAMPLE_TIMEOUT_SECS * GST_SECOND
                )
                if not sample:
                    # EOS, error, or pull timeout: surface errors,
                    # treat clean EOS as end-of-iteration
                    text = lib.pop_error_text(bus)
                    if text:
                        raise VidProc(f"gst decode: {text}")
                    break
                try:
                    buf = lib.sample_get_buffer(sample)
                    st = lib.caps_get_structure(
                        lib.sample_get_caps(sample), 0
                    )
                    if not (
                        lib.structure_get_int(st, b"width", C.byref(w))
                        and lib.structure_get_int(
                            st, b"height", C.byref(h)
                        )
                    ):
                        raise VidProc("gst caps missing dimensions")
                    if not lib.buffer_map(buf, C.byref(info), _MAP_READ):
                        raise VidProc("gst buffer map failed")
                    try:
                        data = np.frombuffer(
                            C.string_at(info.data, info.size),
                            dtype=np.uint8,
                        )
                        stride = data.size // h.value
                        if self.grayscale:
                            yield (
                                data.reshape(h.value, stride)[
                                    :, : w.value
                                ].copy()
                            )
                        else:
                            yield (
                                data.reshape(h.value, stride)[
                                    :, : w.value * 3
                                ]
                                .reshape(h.value, w.value, 3)
                                .copy()
                            )
                    finally:
                        lib.buffer_unmap(buf, C.byref(info))
                finally:
                    lib.mini_object_unref(sample)
        finally:
            lib.set_state(pipe, _STATE_NULL)  # frame_iter.rs:335-347
            if sink:
                lib.object_unref(sink)
            lib.object_unref(bus)
            lib.object_unref(pipe)
