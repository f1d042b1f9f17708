"""The ``VideoHash`` value type.

Behavioral port of the reference's hash value
(``vid_dup_finder_lib/src/video_hashing/video_hash.rs:27-229``): 1000 bits of
sign-quantized 3D-DCT coefficients packed LSB-first, plus the source path and
the duration in whole seconds.

Packing convention (identical to the reference's
``BitArray<[usize; 16], Lsb0>``): hash bit ``i`` lives in 64-bit word
``i // 64`` at bit position ``i % 64``.  The device-side format is the same
bitstream viewed as 32 little-endian ``uint32`` words, so conversion is a
pure ``view`` with no bit shuffling.
"""

from __future__ import annotations

import gc
from collections import deque
from dataclasses import dataclass, field, replace
from itertools import repeat
from typing import Iterable, Iterator

import numpy as np

from .definitions import (
    HASH_BITS,
    HASH_SIZE,
    HASH_WORDS,
    HASH_WORDS32,
    TOLERANCE_SCALING_FACTOR,
)


# many_from_packed_u32 collects once after building this many objects or more
GC_SETTLE_MIN = 1 << 16


class VideoHashBatch(list):
    """A bulk-constructed ``list[VideoHash]`` carrying its backing arrays.

    Produced by :meth:`VideoHash.many_from_packed_u32`.  Behaves exactly
    like a plain list of hashes; additionally exposes the vectorized
    columns the objects were built from so ``Search`` construction can
    skip every per-object Python loop (durations ``np.fromiter``, path
    ``os.fspath`` encode, ``hashes_to_matrix``), which at library scale
    cost more than the sweep itself.

    * ``packed_u32`` — ``uint32[n, 32]``, the device search format (the
      rows' ``hash`` fields are read-only views into this buffer).
    * ``durations`` — ``int64[n]``.
    * ``paths_bytes`` — bytewise path array (``np.bytes_``) for the
      (duration, path) sort, or ``None`` unless every path is a ``str`` of
      ASCII characters other than NUL (:func:`ascii_path_array`;
      ``Search`` then falls back to the exact per-object key).

    Any in-place list mutation (append/sort/item assignment/...) marks
    the arrays stale; consumers must check :attr:`arrays_valid` and fall
    back to per-object iteration.  Slicing returns a plain list.
    """

    __slots__ = ("packed_u32", "durations", "paths_bytes", "arrays_valid")

    def __init__(self, entries, packed_u32, durations, paths_bytes):
        super().__init__(entries)
        self.packed_u32 = packed_u32
        self.durations = durations
        self.paths_bytes = paths_bytes
        self.arrays_valid = True


def _batch_invalidating(name: str):
    base = getattr(list, name)

    def method(self, *args, **kwargs):
        self.arrays_valid = False
        return base(self, *args, **kwargs)

    method.__name__ = name
    return method


for _name in (
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "__setitem__", "__delitem__", "__iadd__", "__imul__",
):
    setattr(VideoHashBatch, _name, _batch_invalidating(_name))
del _name


def ascii_path_array(paths: list) -> np.ndarray | None:
    """``paths`` as one bytewise array (``np.bytes_``, as
    ``np.array(paths, dtype=np.bytes_)`` gives it), or None unless every
    path is a ``str`` of ASCII characters other than NUL: the bytes order
    is then the paths' bytewise order (``os.fsencode``), and equal rows are
    equal paths (a ``np.bytes_`` row drops trailing NULs).  Built from one
    NUL-separated join of the paths, without a Python step per path."""
    try:
        joined = "\x00".join(paths).encode("ascii")
    except (TypeError, UnicodeEncodeError):
        return None
    n = len(paths)
    if n == 0:
        return None
    buf = np.frombuffer(joined + b"\x00", dtype=np.uint8)
    ends = np.flatnonzero(buf == 0)
    if len(ends) != n:  # a path holds a NUL
        return None
    lengths = np.diff(ends, prepend=-1) - 1
    width = max(int(lengths.max()), 1)
    if int(lengths.min()) == width:
        return np.ascontiguousarray(buf.reshape(n, width + 1)[:, :width]).view(f"S{width}").ravel()
    chars = np.zeros((n, width), dtype=np.uint8)
    chars[np.arange(width) < lengths[:, None]] = buf[buf != 0]
    return chars.view(f"S{width}").ravel()


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean vector of length >= HASH_BITS (extra ignored) into
    uint64[HASH_WORDS], LSB-first within each word."""
    bits = np.asarray(bits, dtype=np.uint8)[:HASH_BITS]
    padded = np.zeros(HASH_WORDS * 64, dtype=np.uint8)
    padded[: bits.size] = bits
    # np.packbits packs MSB-first per byte; request little bit order for Lsb0.
    as_bytes = np.packbits(padded, bitorder="little")
    return as_bytes.view("<u8").copy()


def unpack_bits(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_bits: uint64[HASH_WORDS] -> bool[HASH_BITS]."""
    as_bytes = np.asarray(words, dtype="<u8").tobytes()
    bits = np.unpackbits(np.frombuffer(as_bytes, dtype=np.uint8), bitorder="little")
    return bits[:HASH_BITS].astype(bool)


@dataclass(frozen=True, slots=True)
class VideoHash:
    """A perceptual hash of one video file.  Its fields live in slots, with
    no per-object ``__dict__``: a library holds millions of them."""

    hash: np.ndarray = field(
        default_factory=lambda: np.zeros(HASH_WORDS, dtype=np.uint64)
    )  # uint64[16], Lsb0 packing
    src_path: str = ""
    duration: int = 0  # whole seconds (u32 truncation in the reference)

    def __post_init__(self) -> None:
        h = np.asarray(self.hash, dtype=np.uint64)
        assert h.shape == (HASH_WORDS,)
        h.setflags(write=False)
        object.__setattr__(self, "hash", h)

    # -- equality / ordering / hashing --------------------------------------

    def _key(self):
        return (self.hash.tobytes(), self.src_path, self.duration)

    def __eq__(self, other) -> bool:
        if not isinstance(other, VideoHash):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    # -- metric --------------------------------------------------------------

    def hamming_distance(self, other: "VideoHash") -> int:
        """Per-word XOR + popcount (video_hash.rs:190-192,311-317)."""
        return int(np.bitwise_count(self.hash ^ other.hash).sum())

    def normalized_hamming_distance(self, other: "VideoHash") -> float:
        """Raw distance scaled into [0, 1] (video_hash.rs:200-204)."""
        return self.hamming_distance(other) / TOLERANCE_SCALING_FACTOR

    # -- accessors -------------------------------------------------------------

    def raw_hash(self) -> Iterator[bool]:
        """Iterate the 1000 raw hash bits (video_hash.rs:206-218)."""
        return iter(unpack_bits(self.hash).tolist())

    def hash_bits(self) -> np.ndarray:
        """The 1000 hash bits as a bool vector (video_hash.rs:226-229)."""
        return unpack_bits(self.hash)

    @staticmethod
    def hash_frame_dimensions() -> tuple[int, int]:
        return (HASH_SIZE, HASH_SIZE)

    # -- conversions -------------------------------------------------------------

    def packed_u32(self) -> np.ndarray:
        """Device packing: the same bitstream as uint32[32] little-endian."""
        return self.hash.view("<u4").copy()

    @staticmethod
    def from_packed_u32(
        words32: np.ndarray, src_path: str = "", duration: int = 0
    ) -> "VideoHash":
        w = np.ascontiguousarray(words32, dtype="<u4")
        assert w.shape == (HASH_WORDS32,)
        return VideoHash(w.view("<u8").copy(), src_path, duration)

    @staticmethod
    def many_from_packed_u32(
        matrix: np.ndarray,
        src_paths: Iterable[str],
        durations: Iterable[int],
    ) -> "VideoHashBatch":
        """Bulk ``from_packed_u32`` over a ``uint32[k, 32]`` matrix: ONE
        u4->u8 reinterpret of the whole matrix, each hash holding a
        read-only row view (no per-row copy), and far faster than the
        per-row constructor at library scale.

        Returns a :class:`VideoHashBatch` (a ``list`` subclass) whose
        backing arrays let ``Search`` skip all per-object iteration.  The
        objects are made by C-level maps with Python's cyclic GC off (it
        would pass over the growing batch again and again); the caller's
        GC state is restored before returning, also on an error."""
        # a read-only view: a contiguous uint32 matrix is the caller's own
        # array, and the batch must not hand out a writable alias of it
        w32 = np.ascontiguousarray(matrix, dtype="<u4").view()
        w32.setflags(write=False)
        w = w32.view("<u8")
        assert w.shape[1] == HASH_WORDS
        src_paths = list(src_paths)
        if (
            isinstance(durations, np.ndarray)
            and durations.ndim == 1
            and np.can_cast(durations.dtype, np.int64)
        ):
            dur_arr = durations.astype(np.int64)
            durations = dur_arr.tolist()  # Python ints, as int(d) gives them
        else:
            durations = [int(d) for d in durations]
            dur_arr = None
        if not (len(src_paths) == len(durations) == w.shape[0]):
            # a silent zip-truncation here would drop hashes (and their
            # duplicates) without a trace; a too-long paths list would
            # die as an opaque IndexError mid-loop
            raise ValueError(
                f"many_from_packed_u32: matrix has {w.shape[0]} rows"
                f" but got {len(src_paths)} src_paths and"
                f" {len(durations)} durations — all three must match"
            )
        # the frozen-dataclass __init__ + __post_init__ dominate at this
        # volume; validation already happened once on the whole matrix,
        # so construct directly (rows are read-only u64 views)
        k = w.shape[0]
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            out = list(map(VideoHash.__new__, repeat(VideoHash, k)))
            for name, values in (("hash", list(w)), ("src_path", src_paths), ("duration", durations)):
                deque(map(object.__setattr__, out, repeat(name), values), maxlen=0)
            if gc_was_enabled and k >= GC_SETTLE_MIN:
                # the collections the loop skipped, once, here rather than in
                # the caller's next calls: a full one where the new objects
                # are a quarter of the oldest generation or more (when the
                # collector itself would have run one), else the young ones
                gc.collect(2 if 4 * k >= len(gc.get_objects(generation=2)) else 1)
        finally:
            if gc_was_enabled:
                gc.enable()
        return VideoHashBatch(
            out,
            w32[:k],
            np.array(durations, dtype=np.int64) if dur_arr is None else dur_arr,
            ascii_path_array(src_paths),
        )

    @staticmethod
    def from_bits(
        bits: np.ndarray | Iterable[bool], src_path: str = "", duration: int = 0
    ) -> "VideoHash":
        return VideoHash(pack_bits(np.fromiter(bits, dtype=np.uint8, count=-1)
                                   if not isinstance(bits, np.ndarray) else bits),
                         src_path, duration)

    # -- serde (cache format) ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "hash": [int(w) for w in self.hash],
            "src_path": self.src_path,
            "duration": int(self.duration),
        }

    @staticmethod
    def from_json(obj: dict) -> "VideoHash":
        return VideoHash(
            np.array(obj["hash"], dtype=np.uint64), obj["src_path"], int(obj["duration"])
        )

    # -- test utilities (video_hash.rs test_util, :240-308) ------------------------

    def with_duration(self, duration: int) -> "VideoHash":
        return replace(self, duration=duration)

    def with_src_path(self, src_path: str) -> "VideoHash":
        return replace(self, src_path=src_path)

    @staticmethod
    def empty_hash(name: str = "") -> "VideoHash":
        return VideoHash(np.zeros(HASH_WORDS, dtype=np.uint64), name, 0)

    @staticmethod
    def full_hash(name: str = "") -> "VideoHash":
        return VideoHash(np.full(HASH_WORDS, np.uint64(0xFFFFFFFFFFFFFFFF)), name, 0)

    @staticmethod
    def random_hash(rng: np.random.Generator) -> "VideoHash":
        """1000 fair-coin bits; the 24 trailing storage bits stay zero."""
        bits = rng.integers(0, 2, size=HASH_BITS, dtype=np.uint8)
        return VideoHash(pack_bits(bits), "", 0)

    def hash_with_spatial_distance(
        self, target_distance: int, rng: np.random.Generator
    ) -> "VideoHash":
        """A hash at exactly ``target_distance`` from this one.

        The reference (video_hash.rs:263-287) random-walks single-bit flips
        over the full 1024-bit storage until the distance is hit; we flip
        ``target_distance`` distinct random storage bits directly — the same
        contract (exact distance, any storage bit may differ) without the
        walk's exponential slowdown above distance 512.
        """
        words = self.hash.copy()
        positions = rng.choice(HASH_WORDS * 64, size=target_distance, replace=False)
        for p in positions:
            words[p // 64] ^= np.uint64(1) << np.uint64(p % 64)
        assert int(np.bitwise_count(words ^ self.hash).sum()) == target_distance
        return VideoHash(words, self.src_path, self.duration)


def hashes_to_matrix(hashes: list[VideoHash]) -> np.ndarray:
    """Stack hashes into the device search format uint32[N, 32].

    One bytes-join instead of an np.stack of N per-hash arrays (this is
    on the object-API search path ahead of every sweep).  Byte-order safe: the
    stored hash dtype is explicitly little-endian ('<u8').
    """
    if not hashes:
        return np.zeros((0, HASH_WORDS32), dtype=np.uint32)
    buf = b"".join(
        np.asarray(h.hash, dtype="<u8").tobytes() for h in hashes
    )
    return (
        np.frombuffer(buf, dtype="<u4")
        .reshape(len(hashes), HASH_WORDS32)
        .copy()
    )
