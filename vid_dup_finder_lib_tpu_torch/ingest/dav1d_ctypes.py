"""AV1 decoding via a direct ctypes binding to libdav1d.

Companion to ``mp4_av1.py`` (see its module docstring for why): the
reference's two bundled AV1 videos are undecodable by every other
backend in this image, but ``libdav1d.so.6`` (dav1d 1.0) is present.
This binding drives the plain C ``dav1d_*`` API:

* ``Dav1dSettings`` is an opaque oversized zeroed buffer filled by
  ``dav1d_default_settings`` — no field is touched, so its layout never
  matters.
* ``Dav1dData`` payloads are allocated by ``dav1d_data_create`` and
  memmove'd in (no free-callback plumbing); its only field read is
  ``sz`` (offset 8: after the leading ``data`` pointer) to detect
  partial consumption.
* ``Dav1dPicture`` field offsets (data[3] at 16, stride[2] at 40,
  w/h/layout/bpc at 56/60/64/68 — the dav1d >= 0.9 ABI) are VALIDATED
  at runtime: the first decoded picture's dimensions must match the
  container's, otherwise decoding aborts loudly rather than reading
  garbage.

Only 8-bit I420/I400 output is handled (youtube AV1 = yuv420p 8-bit;
``VidProc`` otherwise).  Grayscale output converts limited-range luma
to full range exactly like the other backends' videoconvert/swscale
gray paths; RGB applies the BT.601 limited-range matrix.
"""

from __future__ import annotations

import ctypes as C
import os
import threading
from typing import Iterable, Iterator

import numpy as np

from ..errors import VidProc

_EAGAIN = -11

# Dav1dPicture field offsets (dav1d >= 0.9 ABI; runtime-validated)
_PIC_BYTES = 1024
_OFF_DATA0 = 16
_OFF_DATA1 = 24
_OFF_DATA2 = 32
_OFF_STRIDE0 = 40
_OFF_STRIDE1 = 48
_OFF_W = 56
_OFF_H = 60
_OFF_LAYOUT = 64
_OFF_BPC = 68

_LAYOUT_I400 = 0
_LAYOUT_I420 = 1


class _Lib:
    def __init__(self) -> None:
        self.lib = C.CDLL("libdav1d.so.6")
        lib = self.lib
        lib.dav1d_version.restype = C.c_char_p
        lib.dav1d_default_settings.argtypes = [C.c_void_p]
        lib.dav1d_open.restype = C.c_int
        lib.dav1d_open.argtypes = [C.POINTER(C.c_void_p), C.c_void_p]
        lib.dav1d_data_create.restype = C.c_void_p
        lib.dav1d_data_create.argtypes = [C.c_void_p, C.c_size_t]
        lib.dav1d_data_unref.argtypes = [C.c_void_p]
        lib.dav1d_send_data.restype = C.c_int
        lib.dav1d_send_data.argtypes = [C.c_void_p, C.c_void_p]
        lib.dav1d_get_picture.restype = C.c_int
        lib.dav1d_get_picture.argtypes = [C.c_void_p, C.c_void_p]
        lib.dav1d_picture_unref.argtypes = [C.c_void_p]
        lib.dav1d_close.argtypes = [C.POINTER(C.c_void_p)]
        self.version = lib.dav1d_version().decode()


_LIB: _Lib | None = None
_LIB_ERR: Exception | None = None
_LOCK = threading.Lock()


def _lib() -> _Lib | None:
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            if os.environ.get("VDF_DAV1D", "1") != "1":
                _LIB_ERR = RuntimeError("disabled via VDF_DAV1D=0")
                return None
            try:
                _LIB = _Lib()
            except Exception as e:
                _LIB_ERR = e
    return _LIB


def available() -> bool:
    return _lib() is not None


def _expand_luma(y: np.ndarray) -> np.ndarray:
    """Limited-range (16..235) luma -> full-range u8, like videoconvert
    / swscale gray output."""
    g = (y.astype(np.int32) - 16) * 255
    return np.clip((g + 109) // 219, 0, 255).astype(np.uint8)


def decode_frames(
    samples: Iterable[bytes],
    expect_w: int | None = None,
    expect_h: int | None = None,
    grayscale: bool = True,
) -> Iterator[np.ndarray]:
    """Decode AV1 temporal units -> frames (gray u8 [H, W] or RGB u8
    [H, W, 3]), in presentation order."""
    libw = _lib()
    if libw is None:
        raise VidProc("dav1d unavailable")
    lib = libw.lib

    settings = C.create_string_buffer(512)
    lib.dav1d_default_settings(settings)
    ctx = C.c_void_p()
    if lib.dav1d_open(C.byref(ctx), settings) != 0:
        raise VidProc("dav1d_open failed")
    pic = C.create_string_buffer(_PIC_BYTES)
    data = C.create_string_buffer(128)
    validated = False

    def read_pic() -> np.ndarray:
        nonlocal validated
        base = C.addressof(pic)
        w = C.c_int.from_address(base + _OFF_W).value
        h = C.c_int.from_address(base + _OFF_H).value
        layout = C.c_int.from_address(base + _OFF_LAYOUT).value
        bpc = C.c_int.from_address(base + _OFF_BPC).value
        if not validated:
            ok = 0 < w <= 1 << 15 and 0 < h <= 1 << 15
            if ok and expect_w is not None:
                ok = (w, h) == (expect_w, expect_h)
            if not ok:
                raise VidProc(
                    "dav1d ABI validation failed: picture "
                    f"{w}x{h} vs container {expect_w}x{expect_h}"
                )
            validated = True
        if bpc != 8 or layout not in (_LAYOUT_I400, _LAYOUT_I420):
            raise VidProc(
                f"unsupported AV1 output (layout={layout}, bpc={bpc}); "
                "only 8-bit I420/I400 is handled"
            )
        d0 = C.c_void_p.from_address(base + _OFF_DATA0).value
        s0 = C.c_ssize_t.from_address(base + _OFF_STRIDE0).value
        y = np.frombuffer(
            C.string_at(d0, s0 * h), np.uint8
        ).reshape(h, s0)[:, :w]
        if grayscale or layout == _LAYOUT_I400:
            out = _expand_luma(y)
            if not grayscale:
                out = np.repeat(out[:, :, None], 3, axis=2)
            return out
        d1 = C.c_void_p.from_address(base + _OFF_DATA1).value
        d2 = C.c_void_p.from_address(base + _OFF_DATA2).value
        s1 = C.c_ssize_t.from_address(base + _OFF_STRIDE1).value
        ch, cw = (h + 1) // 2, (w + 1) // 2
        u = np.frombuffer(
            C.string_at(d1, s1 * ch), np.uint8
        ).reshape(ch, s1)[:, :cw]
        v = np.frombuffer(
            C.string_at(d2, s1 * ch), np.uint8
        ).reshape(ch, s1)[:, :cw]
        # BT.601 limited range -> full-range RGB
        yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
        uf = np.repeat(np.repeat(u, 2, 0), 2, 1)[:h, :w].astype(
            np.float32
        ) - 128.0
        vf = np.repeat(np.repeat(v, 2, 0), 2, 1)[:h, :w].astype(
            np.float32
        ) - 128.0
        r = yf + 1.402 * (255.0 / 224.0) * vf
        g = (
            yf
            - 0.344136 * (255.0 / 224.0) * uf
            - 0.714136 * (255.0 / 224.0) * vf
        )
        b = yf + 1.772 * (255.0 / 224.0) * uf
        return np.clip(
            np.stack([r, g, b], axis=2), 0, 255
        ).astype(np.uint8)

    try:
        for sample in samples:
            ptr = lib.dav1d_data_create(data, len(sample))
            if not ptr:
                raise VidProc("dav1d_data_create failed")
            C.memmove(ptr, sample, len(sample))
            while True:
                r = lib.dav1d_send_data(ctx, data)
                if r not in (0, _EAGAIN):
                    lib.dav1d_data_unref(data)
                    raise VidProc(f"dav1d_send_data error {r}")
                rp = lib.dav1d_get_picture(ctx, pic)
                if rp == 0:
                    frame = read_pic()
                    lib.dav1d_picture_unref(pic)
                    yield frame
                elif rp != _EAGAIN:
                    raise VidProc(f"dav1d_get_picture error {rp}")
                if r == 0:
                    # sz (offset 8) == 0 once fully consumed
                    if not C.c_size_t.from_address(
                        C.addressof(data) + 8
                    ).value:
                        break
        while True:  # drain delayed frames at EOS
            rp = lib.dav1d_get_picture(ctx, pic)
            if rp != 0:
                break
            frame = read_pic()
            lib.dav1d_picture_unref(pic)
            yield frame
    finally:
        # a consumer abandoning the iterator mid-sample (the reader's
        # take-N path) leaves a partially-consumed payload ref behind —
        # unref is a no-op when the struct is empty/zeroed
        lib.dav1d_data_unref(data)
        lib.dav1d_close(C.byref(ctx))
