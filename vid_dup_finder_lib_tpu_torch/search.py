"""Duplicate search on the port: ``search`` / ``search_with_references``
(counterpart of ``vid_dup_finder_lib_tpu/search.py``).

Semantics are an exact behavioural port of the reference's greedy search
(``vid_dup_finder_lib/src/video_hashing/search_algorithm.rs`` and
``video_dup_finder.rs``):

* entries are sorted by ``(duration, src_path)`` (bytewise path order) for
  determinism;
* ``search_self`` sweeps a two-pointer duration window (rhs advances while
  ``duration <= int(lhs_duration * 1.1)``), each target greedily consumes
  unmatched candidates within ``int(tolerance * 1000)`` Hamming distance;
* ``search_with_references`` uses a symmetric ``[int(0.95 d), int(1.05 d)]``
  window and does not consume candidates.

The device computes the *adjacency* (which pairs are within tolerance):
the duration-banded adjacency of the self-search through
:func:`.ops.hamming.banded_adjacency`, the batched references search
through :func:`.ops.hamming.refs_adjacency`, both on the Search's device.
The greedy pass is replayed on the host in the reference's sort order over
that adjacency.  Because durations are sorted, the reference's
matched-entry skipping in ``advance_rhs`` never changes the candidate set,
so replaying over a precomputed duration-windowed adjacency is exact.

Backends of ``search``:

* ``"auto"``: below 4096 entries the reference's pairwise loop; above it
  the two-phase adjacency on a CUDA ``device``, and on the CPU the native
  sweep when its library is available, else the two-phase adjacency's plain
  versions;
* ``"device"``: the two-phase adjacency (K2 + K3) on ``device`` at any size;
* ``"native"``: the adjacency from the C++ XOR + POPCNT sweep on the host's
  cores (:mod:`.native`) at any size; raises when it cannot be built;
* ``"band"``: the whole-band adjacency (K4) on ``device`` at any size;
* ``"ring"``: the two-phase adjacency over the shards of
  ``parallel.mesh.make_mesh(device=device)`` (every visible card, or one CPU
  shard; :mod:`.parallel.ring_cuda`) at any size, from the host matrix also
  when a library is attached, as in the JAX package; ``auto`` never takes it;
* ``"host"``: the adjacency from the NumPy sweep
  (:func:`.ops.hamming.banded_adjacency_host`);
* ``"naive"``: the pairwise loop at any size.

A device-resident library (:class:`.ops.hamming_cuda.IncrementalDeviceLibrary`,
``device_library=``) replaces the host packed matrix: the sweep states are
built from its rows on the device, and only the references travel host to
device.  ``auto`` and ``device`` then sweep by K2 + K3, ``band`` by K4, at
any size; ``host``, ``native`` and ``naive`` keep to the host.

A Search on the CPU without a resident library also takes the native
library for the batched references search (unless ``VDF_REFS_NATIVE=0``);
one on a CUDA device never sweeps with it.  The batched references search
splits the references over ``make_mesh(device=device)``
(:func:`.parallel.refs_sharded.refs_adjacency_sharded`) only when
``VDF_REFS_SHARDED=1``.  ``search_one`` measures its
distances with it on any host that can build it, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np
import torch

from .definitions import (
    DEFAULT_SEARCH_TOLERANCE,
    REF_SEARCH_DURATION_HI,
    REF_SEARCH_DURATION_LO,
    SELF_SEARCH_DURATION_FACTOR,
    TOLERANCE_SCALING_FACTOR,
)
from . import native
from .match_group import MatchGroup, TooFewEntries
from .ops.hamming import banded_adjacency, refs_adjacency
from .ops.hamming_band import banded_adjacency_band
from .ops.hamming_cuda import IncrementalDeviceLibrary, banded_adjacency_cuda
from .utils.device import resolve_device
from .video_hash import VideoHash, VideoHashBatch, hashes_to_matrix

BACKENDS = ("auto", "device", "band", "host", "native", "ring", "naive")

# auto backend: the device adjacency from this many entries up
_DEVICE_SEARCH_THRESHOLD = 4096

# search_with_references batches the references from this many up
_BATCHED_REFS_THRESHOLD = 64


def _sort_key(h: VideoHash):
    # search_algorithm.rs:54-60 — (duration, src_path); PathBuf compares
    # bytewise, which os.fsencode reproduces for any unicode path.
    return (h.duration, os.fsencode(h.src_path))


def _tolerance_int(tolerance: float) -> int:
    # `(tolerance * 1000.0) as u32` — Rust float->u32 casts saturate at 0.
    return max(0, int(tolerance * TOLERANCE_SCALING_FACTOR))


class Search:
    """Sorted hash store for duplicate searches (search_algorithm.rs:19-199),
    sweeping on ``device``."""

    def __init__(
        self,
        hashes: Iterable[VideoHash] = (),
        device: torch.device | str | None = None,
    ) -> None:  # Search::from + seed
        self.device = resolve_device(device)
        # A VideoHashBatch (many_from_packed_u32) carries its duration,
        # bytewise-path and packed-matrix columns, so the constructor does
        # no per-object Python work.
        packed_mat: np.ndarray | None = None
        durations = paths = None
        if (
            isinstance(hashes, VideoHashBatch)
            and hashes.arrays_valid
            and hashes.paths_bytes is not None
        ):
            durations = hashes.durations
            paths = hashes.paths_bytes
            packed_mat = hashes.packed_u32
        elif isinstance(hashes, VideoHashBatch) and hashes.arrays_valid:
            packed_mat = hashes.packed_u32
        entries = list(hashes)
        # Vectorised (duration, bytewise-path) sort: PathBuf compares
        # bytewise and numpy's S dtype does too, so an all-ASCII path
        # array sorts identically under np.lexsort (stable, like Python's
        # sorted).  Non-ASCII paths (where UTF-8 byte order and str
        # code-point order can disagree on surrogate-escaped bytes) take
        # the exact Python key.
        if entries and durations is None:
            durations = np.fromiter(
                (e.duration for e in entries), dtype=np.int64, count=len(entries)
            )
            try:
                paths = np.array([os.fspath(e.src_path) for e in entries], dtype=np.bytes_)
            except (UnicodeEncodeError, TypeError, ValueError):
                paths = None
        # whether the constructor re-sorted the input: the identity order
        # of attach_device_library(lib, None) is only trusted when it did not
        self._ctor_resorted: bool | None = False
        if entries:
            if paths is not None:
                # O(n) sortedness check first: bulk handoffs arrive sorted
                is_sorted = bool((durations[1:] >= durations[:-1]).all()) and bool(
                    ((durations[1:] != durations[:-1]) | (paths[1:] >= paths[:-1])).all()
                )
                order = None if is_sorted else np.lexsort((paths, durations))
            else:
                keys = [_sort_key(e) for e in entries]
                order = np.array(sorted(range(len(entries)), key=keys.__getitem__), np.int64)
                if np.array_equal(order, np.arange(len(entries))):
                    order = None
            # the Python-key sort leaves the order unknown to the identity
            # check of attach_device_library(lib, None), as in the JAX package
            self._ctor_resorted = order is not None if paths is not None else None
            if order is not None:
                ent_arr = np.empty(len(entries), dtype=object)
                ent_arr[:] = entries
                entries = ent_arr[order].tolist()
                durations = durations[order]
                if packed_mat is not None:
                    # the batch's matrix follows its entries (the JAX
                    # package drops it on non-ASCII paths)
                    packed_mat = np.ascontiguousarray(packed_mat[order])
        if durations is None:
            durations = np.zeros(0, dtype=np.int64)
        self.entries: list[VideoHash] = entries
        self.matched = np.zeros(len(self.entries), dtype=bool)
        self._durations = durations
        # CSR adjacency: row i's in-tolerance candidates (sorted, j > i)
        # are _adj_j[_adj_off[i] : _adj_off[i + 1]]
        self._adj_j: np.ndarray | None = None
        self._adj_off: np.ndarray | None = None
        self._tol_of_adjacency: int | None = None
        # attached IncrementalDeviceLibrary, the insertion index of each
        # sorted entry, and the library's rows in sorted order (refs path)
        self._library: IncrementalDeviceLibrary | None = None
        self._library_order: np.ndarray | None = None
        self._cands_dev: torch.Tensor | None = None
        # host packed matrix, built once (a VideoHashBatch seeds it)
        self._packed_mat: np.ndarray | None = packed_mat

    def _packed_matrix(self) -> np.ndarray:
        if self._packed_mat is None:
            self._packed_mat = hashes_to_matrix(self.entries)
        return self._packed_mat

    def seed(self, new_entries: Iterable[VideoHash]) -> None:
        self.entries = sorted(list(self.entries) + list(new_entries), key=_sort_key)
        self.matched = np.zeros(len(self.entries), dtype=bool)
        self._durations = np.array([e.duration for e in self.entries], dtype=np.int64)
        self._adj_j = self._adj_off = None
        # the attached library no longer covers the entries
        self._cands_dev = None
        self._library = None
        self._library_order = None
        self._packed_mat = None
        # the entries were re-sorted: attach_device_library(lib, None)
        # must spot-check the library's order again (the JAX package
        # keeps the old flag here)
        self._ctor_resorted = None

    # -- distance plumbing ---------------------------------------------------

    def _distance(self, i: int, j: int) -> int:
        return self.entries[i].hamming_distance(self.entries[j])

    def _ensure_adjacency(self, tolerance_int: int, backend: str) -> None:
        """For every entry i, the sorted candidate indices j > i within the
        self-search duration window and Hamming tolerance."""
        if self._adj_j is not None and self._tol_of_adjacency == tolerance_int:
            return
        bounds = self._self_search_bounds()
        if self._library is not None and backend in ("auto", "device", "band"):
            state = self._library.state(self._library_order, bounds)
            if backend == "band":
                pairs_i, pairs_j = banded_adjacency_band(
                    None, None, tolerance_int, state=state
                )
            else:
                pairs_i, pairs_j = banded_adjacency_cuda(state, tolerance_int)
        else:
            pairs_i, pairs_j = banded_adjacency(
                self._packed_matrix(),
                bounds,
                tolerance_int,
                backend=backend,
                device=self.device,
            )
        # pairs are lexsorted by (i, j): CSR by one searchsorted
        self._adj_j = pairs_j
        self._adj_off = np.searchsorted(pairs_i, np.arange(len(self.entries) + 1))
        self._tol_of_adjacency = tolerance_int

    def _self_search_bounds(self) -> np.ndarray:
        """For each i, the exclusive upper index bound of the +10% duration
        window (search_algorithm.rs:99)."""
        thresh = (
            self._durations.astype(np.float64) * SELF_SEARCH_DURATION_FACTOR
        ).astype(np.int64)  # trunc, like `as u32`
        return np.searchsorted(self._durations, thresh, side="right")

    # -- searches ------------------------------------------------------------

    def search_self(self, tolerance: float, backend: str = "auto") -> list[list[str]]:
        """All-pairs greedy dedup (search_algorithm.rs:81-171)."""
        n = len(self.entries)
        if n == 0:
            return []
        tol = _tolerance_int(tolerance)

        use_adjacency = backend != "naive" and (
            backend in ("device", "host", "band", "native", "ring")
            or n >= _DEVICE_SEARCH_THRESHOLD
            or self._library is not None
        )
        if use_adjacency:
            self._ensure_adjacency(tol, backend)

        bounds = self._self_search_bounds()
        matched = self.matched
        ret: list[list[str]] = []
        if use_adjacency:
            # greedy consume, replaying the reference's consume order:
            # (a) within one target's scan every still-unmatched
            #     in-tolerance candidate is consumed at once
            #     (search_algorithm.rs:149-156);
            # (b) rows with no in-tolerance candidate are skipped: they
            #     form no group and consume nothing, and since candidates
            #     satisfy j > lhs an empty row is never a later row's
            #     candidate.  The reference's all-visited post-condition
            #     (search_algorithm.rs:131-136) is restored by the fill.
            rows = np.nonzero(self._adj_off[1:] > self._adj_off[:-1])[0]
            for lhs in rows:
                lhs = int(lhs)
                if matched[lhs]:
                    continue
                matched[lhs] = True
                cands = self._adj_j[self._adj_off[lhs] : self._adj_off[lhs + 1]]
                sel = cands[~matched[cands]]
                if sel.size == 0:
                    continue
                match_vec = [self.entries[int(j)].src_path for j in sel]
                matched[sel] = True
                match_vec.append(self.entries[lhs].src_path)
                ret.append(match_vec)
            matched[:] = True
        else:
            for lhs in range(n):
                if matched[lhs]:
                    continue
                matched[lhs] = True
                match_vec = []
                for j in range(lhs + 1, int(bounds[lhs])):
                    if matched[j]:
                        continue
                    if self._distance(lhs, int(j)) <= tol:
                        match_vec.append(self.entries[int(j)].src_path)
                        matched[j] = True
                if match_vec:
                    match_vec.append(self.entries[lhs].src_path)
                    ret.append(match_vec)
        ret.reverse()  # search_algorithm.rs:136,167
        return ret

    def _duration_slice(self, duration_secs: int) -> tuple[int, int]:
        """[0.95 d, 1.05 d] window bounds (search_algorithm.rs:173-185)."""
        lo = int(float(duration_secs) * REF_SEARCH_DURATION_LO)
        hi = int(float(duration_secs) * REF_SEARCH_DURATION_HI)
        lhs = int(np.searchsorted(self._durations, lo, side="left"))
        rhs = int(np.searchsorted(self._durations, hi, side="right"))
        return lhs, rhs

    def search_one(self, target: VideoHash, tolerance: float, consume: bool) -> list[str]:
        """(search_algorithm.rs:63-77)"""
        tol = _tolerance_int(tolerance)
        lhs, rhs = self._duration_slice(target.duration)
        ret: list[str] = []
        if rhs > lhs:
            dists = _distances_one_to_many(target, self.entries[lhs:rhs])
            for off, d in enumerate(dists):
                j = lhs + off
                if not self.matched[j] and d <= tol:
                    ret.append(self.entries[j].src_path)
                    if consume:
                        self.matched[j] = True
        return ret

    def search_with_references(
        self, references: Sequence[VideoHash], tolerance: float, consume: bool
    ) -> list[list[str]]:
        return [self.search_one(r, tolerance, consume) for r in references]

    def search_with_references_batched(
        self, references: Sequence[VideoHash], tolerance: float
    ) -> list[list[str]]:
        """Non-consuming multi-reference search, output-identical to
        ``search_one(consume=False)`` per reference
        (video_dup_finder.rs:19-46): the references, sorted by duration,
        are swept against their [0.95d, 1.05d] windows in one
        :func:`.ops.hamming.refs_adjacency` on the Search's device, over
        the attached library's rows when there is one, or split over the
        shards of ``make_mesh(device=self.device)``
        (:func:`.parallel.refs_sharded.refs_adjacency_sharded`) when
        ``VDF_REFS_SHARDED=1``.  Otherwise a Search on the CPU
        without a library runs each window through
        :func:`.native.refs_windowed_native` instead when that is available
        and ``VDF_REFS_NATIVE`` is not ``0``.  Candidates already
        ``matched`` are dropped after the sweep; each reference's matches
        come in ascending candidate order, and the results in input
        order."""
        tol = _tolerance_int(tolerance)
        refs = list(references)
        if not refs or not self.entries:
            return [[] for _ in refs]
        order = sorted(range(len(refs)), key=lambda k: refs[k].duration)
        windows = np.array(
            [self._duration_slice(refs[k].duration) for k in order], np.int64
        )
        ref_mat = hashes_to_matrix([refs[k] for k in order])
        cands = self._ensure_cands_dev()
        if os.environ.get("VDF_REFS_SHARDED") == "1":
            # imported here: a process that never shards loads none of it
            from .parallel.mesh import make_mesh
            from .parallel.refs_sharded import refs_adjacency_sharded

            pi, pj = refs_adjacency_sharded(
                ref_mat,
                windows[:, 0],
                windows[:, 1],
                tol,
                cands_packed=self._packed_matrix() if cands is None else None,
                cands_dev=cands,
                n_cands=len(self.entries),
                mesh=make_mesh(device=self.device),
            )
        elif (
            cands is None
            and self.device.type == "cpu"
            and os.environ.get("VDF_REFS_NATIVE", "1") != "0"
            and native.available()
        ):
            pi, pj = native.refs_windowed_native(
                ref_mat.view(np.uint64),
                np.ascontiguousarray(self._packed_matrix()).view(np.uint64),
                windows[:, 0],
                windows[:, 1],
                tol,
            )
        else:
            pi, pj = refs_adjacency(
                ref_mat,
                self._packed_matrix() if cands is None else cands,
                windows[:, 0],
                windows[:, 1],
                tol,
                device=self.device,
                n_cands=len(self.entries),
            )
        keep = ~self.matched[pj]
        results: list[list[str]] = [[] for _ in refs]
        for i, j in zip(pi[keep].tolist(), pj[keep].tolist()):
            results[order[i]].append(self.entries[j].src_path)
        return results

    def attach_device_library(
        self,
        library: IncrementalDeviceLibrary,
        insertion_paths: Sequence[str] | None,
    ) -> None:
        """Use a device-resident packed library as the candidate matrix.

        ``library``: an :class:`.ops.hamming_cuda.IncrementalDeviceLibrary`
        on this Search's device whose rows were appended in
        ``insertion_paths`` order (one src_path per row; where a path
        repeats, its last row counts).  Every entry of this Search must
        appear in ``insertion_paths``.  ``insertion_paths=None``: the rows
        were appended in this Search's sorted (duration, src_path) order,
        one per entry; the sweep state then shares the library's buffer.

        Both search flavours then skip the host matrix: ``search_self``
        builds its sweep state from the resident rows
        (:meth:`IncrementalDeviceLibrary.state`), and the batched
        references search takes them as its candidate columns.
        """
        if library.device != self.device:
            raise ValueError(
                f"attach_device_library: the library lies on {library.device}"
                f" but this Search sweeps on {self.device}"
            )
        if insertion_paths is None:
            if library.n != len(self.entries):
                raise ValueError(
                    f"attach_device_library(insertion_paths=None): the"
                    f" library holds {library.n} rows but this Search"
                    f" has {len(self.entries)} entries — identity order"
                    f" requires exactly one row per entry (pass"
                    f" insertion_paths for a superset library)"
                )
            # a misaligned identity order would sweep the wrong rows: when
            # the entries were (or may have been) re-sorted, spot-check a
            # few library rows against the sorted entries
            if self._ctor_resorted is not False and self.entries:
                n = len(self.entries)
                sample = sorted({0, n // 3, (2 * n) // 3, n - 1})
                got = self._library_rows(library, sample)
                for k, i in enumerate(sample):
                    if not np.array_equal(got[k], self.entries[i].packed_u32()):
                        raise ValueError(
                            f"attach_device_library(insertion_paths="
                            f"None): library row {i} does not match"
                            f" this Search's sorted entry {i} — the"
                            f" rows were not appended in sorted"
                            f" (duration, src_path) order.  Pass"
                            f" insertion_paths (one src_path per"
                            f" appended row) or append pre-sorted."
                        )
            order = np.arange(len(self.entries), dtype=np.int64)
        else:
            idx = {p: i for i, p in enumerate(insertion_paths)}
            try:
                order = np.array(
                    [idx[e.src_path] for e in self.entries], dtype=np.int64
                )
            except KeyError as e:
                raise ValueError(
                    f"attach_device_library: entry src_path {e.args[0]!r}"
                    f" has no row in insertion_paths — every Search"
                    f" entry must have been appended to the library"
                ) from None
            if order.size and int(order.max()) >= library.n:
                k = int(np.argmax(order))
                raise ValueError(
                    f"attach_device_library: insertion_paths puts entry"
                    f" {self.entries[k].src_path!r} at row {int(order[k])}"
                    f" but the library holds only {library.n} rows"
                )
        self._library = library
        self._library_order = order
        self._cands_dev = None  # gathered lazily by the refs path
        self._adj_j = self._adj_off = None  # adjacency source changed

    @staticmethod
    def _library_rows(library: IncrementalDeviceLibrary, idx) -> np.ndarray:
        """Host fetch of a few library rows (identity-order spot-check)."""
        return library.take_rows(idx)

    def _ensure_cands_dev(self) -> torch.Tensor | None:
        """The attached library's rows in this Search's sorted order, the
        references search's candidate matrix (None without a library);
        cached after the first call.  Identity order shares the library's
        buffer."""
        if self._cands_dev is None and self._library is not None:
            self._cands_dev = self._library.sorted_rows(self._library_order)
        return self._cands_dev


def _distances_one_to_many(target: VideoHash, entries: list[VideoHash]) -> np.ndarray:
    if not entries:
        return np.zeros(0, dtype=np.int64)
    mat = hashes_to_matrix(entries)
    if native.available():
        return native.distances_one_native(target.packed_u32(), mat)
    t = target.packed_u32()[None, :]
    return np.bitwise_count(mat ^ t).sum(axis=1).astype(np.int64)


def _groups(matches: list[list[str]]) -> list[MatchGroup]:
    out = []
    for g in matches:
        try:
            out.append(MatchGroup.new(g))
        except TooFewEntries:
            pass
    return out


def search(
    hashes: Iterable[VideoHash],
    tolerance: float | None = None,
    backend: str = "auto",
    device: torch.device | str | None = None,
    device_library: IncrementalDeviceLibrary | None = None,
    library_paths: Sequence[str] | None = None,
) -> list[MatchGroup]:
    """Groups of mutual duplicates within ``hashes``
    (``vid_dup_finder_lib::search``); ``tolerance`` in [0, 1].

    ``device_library`` + ``library_paths``: a library on ``device`` whose
    rows are the packed hashes of ``hashes`` appended in ``library_paths``
    order, or in this search's (duration, src_path) order when
    ``library_paths`` is None (:meth:`Search.attach_device_library`).

    With ``backend="auto"`` the environment variable ``VDF_SEARCH_BACKEND``,
    when set, names the backend (one of ``BACKENDS``), as in the JAX
    package; a backend the port does not have raises ``ValueError``.
    ``backend="native"`` raises ``RuntimeError`` when the native library
    cannot be built."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        backend = os.environ.get("VDF_SEARCH_BACKEND", "auto")
        if backend not in BACKENDS:
            raise ValueError(
                f"VDF_SEARCH_BACKEND={backend!r} names no backend of this"
                f" package; expected one of {BACKENDS}"
            )
    if tolerance is None:
        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(hashes, device=device)
    if device_library is not None:
        s.attach_device_library(device_library, library_paths)
    return _groups(s.search_self(tolerance, backend=backend))


def search_with_references(
    ref_hashes: Iterable[VideoHash],
    new_hashes: Iterable[VideoHash],
    tolerance: float | None = None,
    device: torch.device | str | None = None,
    device_library: IncrementalDeviceLibrary | None = None,
    library_paths: Sequence[str] | None = None,
) -> list[MatchGroup]:
    """Per reference video, its duplicates among ``new_hashes``
    (``vid_dup_finder_lib::search_with_references``), non-consuming.  From
    64 references up, or whenever ``device_library`` holds the candidates
    (as in :func:`search`), one batched sweep on ``device``
    (:meth:`Search.search_with_references_batched`); otherwise one
    reference at a time on the host, as the JAX package does."""
    if tolerance is None:
        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(new_hashes, device=device)
    if device_library is not None:
        s.attach_device_library(device_library, library_paths)
    refs = list(ref_hashes)
    if len(refs) >= _BATCHED_REFS_THRESHOLD or device_library is not None:
        all_matches = s.search_with_references_batched(refs, tolerance)
    else:
        all_matches = s.search_with_references(refs, tolerance, consume=False)
    out: list[MatchGroup] = []
    for ref, matches in zip(refs, all_matches):
        if matches:
            try:
                out.append(MatchGroup.new_with_reference(ref.src_path, matches))
            except TooFewEntries:
                pass
    return out
