"""Minimal ISOBMFF (mp4) demuxer for AV1 video tracks.

The reference bundles two AV1 videos (`examples/obtain_videos.sh:24`
downloads youtube format 394) that its gstreamer/ffmpeg backends decode
through system codecs.  This image has no AV1-capable decoder in either
OpenCV's bundled ffmpeg or the gst base plugins — but `libdav1d` is
present, so AV1 ingest is: this demuxer extracts the track's temporal
units (each mp4 sample is a sequence of size-field OBUs, which dav1d
accepts directly) and ``dav1d_ctypes.py`` decodes them.

Scope: enough of ISO/IEC 14496-12 to read progressive (non-fragmented)
files with an ``av01`` sample entry — box walk, ``stsd`` codec check,
``stsz``/``stco``+``co64``/``stsc`` sample layout, ``stts``/``mdhd``
timing.  Raises ``VidProc`` on anything else.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

from ..errors import VidProc

_FTYP_PEEK = 16


@dataclass(frozen=True)
class Av1Track:
    """Sample layout + timing of one av01 video track."""

    sample_spans: list[tuple[int, int]]  # (file offset, size) per sample
    width: int
    height: int
    timescale: int
    duration: float  # seconds
    fps: float  # timescale / modal stts delta

    @property
    def n_samples(self) -> int:
        return len(self.sample_spans)


def _boxes(buf: bytes, start: int, end: int):
    off = start
    while off + 8 <= end:
        size, typ = struct.unpack_from(">I4s", buf, off)
        hdr = 8
        if size == 1:
            if off + 16 > end:
                return
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        if size < hdr or off + size > end:
            return  # malformed; stop walking
        yield typ, off + hdr, off + size
        off += size


def _find_all(buf: bytes, start: int, end: int, path: tuple[bytes, ...]):
    if not path:
        yield start, end
        return
    for typ, b, e in _boxes(buf, start, end):
        if typ == path[0]:
            yield from _find_all(buf, b, e, path[1:])


def _find1(buf, start, end, path) -> tuple[int, int] | None:
    return next(_find_all(buf, start, end, tuple(path)), None)


_MOOV_SNIFF_CAP = 64 << 20  # refuse absurd moov sizes in the sniff


def _read_moov(fh) -> bytes | None:
    """Seek-walk the top-level boxes and return the moov payload only —
    the sniff must not read a multi-GB mdat into memory."""
    fh.seek(0, 2)
    end = fh.tell()
    off = 0
    while off + 8 <= end:
        fh.seek(off)
        hdr = fh.read(8)
        if len(hdr) < 8:
            return None
        size, typ = struct.unpack(">I4s", hdr)
        hdr_len = 8
        if size == 1:
            big = fh.read(8)
            if len(big) < 8:
                return None
            size = struct.unpack(">Q", big)[0]
            hdr_len = 16
        elif size == 0:
            size = end - off
        if size < hdr_len or off + size > end:
            return None
        if typ == b"moov":
            if size - hdr_len > _MOOV_SNIFF_CAP:
                return None
            return fh.read(size - hdr_len)
        off += size
    return None


def is_av1_mp4(src_path: str | os.PathLike) -> bool:
    """Cheap sniff: an ISOBMFF file whose moov carries an av01 track.

    Reads only the box headers plus the moov payload (seek-walk) — a
    multi-GB non-AV1 mp4 costs a few KB of reads, not a full load."""
    try:
        with open(src_path, "rb") as fh:
            head = fh.read(_FTYP_PEEK)
            if len(head) < 8 or head[4:8] != b"ftyp":
                return False
            moov = _read_moov(fh)
        if moov is None:
            return False
        for trak in _find_all(moov, 0, len(moov), (b"trak",)):
            stsd = _find1(
                moov, trak[0], trak[1], [b"mdia", b"minf", b"stbl", b"stsd"]
            )
            if stsd is None:
                continue
            entry_off = stsd[0] + 8
            if moov[entry_off + 4 : entry_off + 8] == b"av01":
                return True
        return False
    except (VidProc, OSError, struct.error):
        return False


def parse_av1_mp4(src_path: str | os.PathLike) -> Av1Track:
    """Parse the first ``av01`` video track of an mp4 file.

    Seek-walks the top-level boxes and loads only the moov payload —
    sample chunk offsets are absolute file offsets, so the (potentially
    huge) mdat never touches memory; the reader streams samples by
    seek afterwards.
    """
    with open(src_path, "rb") as fh:
        buf = _read_moov(fh)
    if buf is None:
        raise VidProc("mp4: no moov box")
    try:
        return _parse_av1_tracks(buf)
    except VidProc:
        raise
    except (struct.error, IndexError, ValueError, OverflowError) as e:
        # malformed tables (e.g. an stsz count past the buffer) must
        # surface as the package's decode error, not a struct crash —
        # builder error-caching depends on it
        raise VidProc(f"mp4: malformed container ({e})") from None


def _parse_av1_tracks(buf: bytes) -> Av1Track:
    """Parse the first av01 track from a moov PAYLOAD (chunk offsets in
    stco/co64 are absolute file offsets, so the mdat never needs to be
    in memory)."""
    moov = (0, len(buf))
    for trak in _find_all(buf, moov[0], moov[1], (b"trak",)):
        hdlr = _find1(buf, trak[0], trak[1], [b"mdia", b"hdlr"])
        if hdlr is None or buf[hdlr[0] + 8 : hdlr[0] + 12] != b"vide":
            continue
        stbl = _find1(
            buf, trak[0], trak[1], [b"mdia", b"minf", b"stbl"]
        )
        if stbl is None:
            continue
        stsd = _find1(buf, stbl[0], stbl[1], [b"stsd"])
        if stsd is None:
            continue
        _vf, count = struct.unpack_from(">II", buf, stsd[0])
        entry_off = stsd[0] + 8
        fmt = buf[entry_off + 4 : entry_off + 8]
        if fmt != b"av01":
            continue
        # VisualSampleEntry: 4 size + 4 fmt + 6 reserved + 2 dref +
        # 16 predefined/reserved -> width/height u16 at +32
        width, height = struct.unpack_from(">HH", buf, entry_off + 32)

        # timing
        mdhd = _find1(buf, trak[0], trak[1], [b"mdia", b"mdhd"])
        if mdhd is None:
            raise VidProc("mp4: av01 track missing mdhd")
        ver = buf[mdhd[0]]
        if ver == 0:
            _, _, timescale, dur = struct.unpack_from(
                ">IIII", buf, mdhd[0] + 4
            )
        else:
            _, _, timescale, dur = struct.unpack_from(
                ">QQIQ", buf, mdhd[0] + 4
            )
        stts = _find1(buf, stbl[0], stbl[1], [b"stts"])
        if stts is None:
            raise VidProc("mp4: av01 track missing stts")
        _, n_stts = struct.unpack_from(">II", buf, stts[0])
        deltas: dict[int, int] = {}
        for i in range(n_stts):
            cnt, delta = struct.unpack_from(
                ">II", buf, stts[0] + 8 + 8 * i
            )
            deltas[delta] = deltas.get(delta, 0) + cnt
        modal_delta = max(deltas, key=deltas.get) if deltas else 1
        fps = timescale / max(modal_delta, 1)

        # sample sizes
        stsz = _find1(buf, stbl[0], stbl[1], [b"stsz"])
        if stsz is None:
            raise VidProc("mp4: av01 track missing stsz")
        _, dflt, n = struct.unpack_from(">III", buf, stsz[0])
        if dflt:
            sizes = [dflt] * n
        else:
            sizes = list(struct.unpack_from(f">{n}I", buf, stsz[0] + 12))

        # chunk offsets (stco or co64)
        stco = _find1(buf, stbl[0], stbl[1], [b"stco"])
        if stco is not None:
            _, n_ch = struct.unpack_from(">II", buf, stco[0])
            chunk_offs = list(
                struct.unpack_from(f">{n_ch}I", buf, stco[0] + 8)
            )
        else:
            co64 = _find1(buf, stbl[0], stbl[1], [b"co64"])
            if co64 is None:
                raise VidProc("mp4: av01 track missing stco/co64")
            _, n_ch = struct.unpack_from(">II", buf, co64[0])
            chunk_offs = list(
                struct.unpack_from(f">{n_ch}Q", buf, co64[0] + 8)
            )

        # samples per chunk (stsc runs)
        stsc = _find1(buf, stbl[0], stbl[1], [b"stsc"])
        if stsc is None:
            raise VidProc("mp4: av01 track missing stsc")
        _, n_sc = struct.unpack_from(">II", buf, stsc[0])
        runs = [
            struct.unpack_from(">III", buf, stsc[0] + 8 + 12 * i)[:2]
            for i in range(n_sc)
        ]  # (first_chunk 1-based, samples_per_chunk)

        spans: list[tuple[int, int]] = []
        si = 0
        for ri, (first_chunk, per_chunk) in enumerate(runs):
            last_chunk = (
                runs[ri + 1][0] - 1 if ri + 1 < len(runs) else n_ch
            )
            for ch in range(first_chunk - 1, last_chunk):
                off = chunk_offs[ch]
                for _ in range(per_chunk):
                    if si >= n:
                        break
                    spans.append((off, sizes[si]))
                    off += sizes[si]
                    si += 1
        if si != n:
            raise VidProc(
                f"mp4: sample layout mismatch ({si} placed, stsz says {n})"
            )
        return Av1Track(
            sample_spans=spans,
            width=int(width),
            height=int(height),
            timescale=int(timescale),
            duration=dur / timescale if timescale else 0.0,
            fps=float(fps),
        )
    raise VidProc("mp4: no av01 video track")
