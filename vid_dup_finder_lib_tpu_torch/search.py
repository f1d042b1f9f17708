"""Duplicate search on the port: ``search`` / ``search_with_references``.

``Search`` subclasses the JAX package's ``Search`` and overrides how the
device does its part: the duration-banded adjacency of the self-search
(``_ensure_adjacency``, through :func:`.ops.hamming.banded_adjacency`) and
the batched references search (``search_with_references_batched``, through
:func:`.ops.hamming.refs_adjacency`), both on the Search's device.
Sorting, windows and the greedy replay of the reference's consume order
are the JAX package's own code, so groups match it by construction.

Backends of ``search``:

* ``"auto"``: below 4096 entries the reference's pairwise loop, above it
  the two-phase adjacency on ``device``;
* ``"device"``: the two-phase adjacency (K2 + K3) on ``device`` at any size;
* ``"band"``: the whole-band adjacency (K4) on ``device`` at any size;
* ``"host"``: the adjacency from the JAX package's NumPy sweep;
* ``"naive"``: the pairwise loop at any size.

A device-resident library (:class:`.ops.hamming_cuda.IncrementalDeviceLibrary`,
``device_library=``) replaces the host packed matrix: the sweep states are
built from its rows on the device, and only the references travel host to
device.  ``auto`` and ``device`` then sweep by K2 + K3, ``band`` by K4, at
any size; ``host`` and ``naive`` keep to the host.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from vid_dup_finder_lib_tpu.search import _BATCHED_REFS_THRESHOLD, _tolerance_int
from vid_dup_finder_lib_tpu.search import Search as _RefSearch
from vid_dup_finder_lib_tpu.video_hash import hashes_to_matrix

from .definitions import DEFAULT_SEARCH_TOLERANCE
from .match_group import MatchGroup, TooFewEntries
from .ops.hamming import banded_adjacency, refs_adjacency
from .ops.hamming_band import banded_adjacency_band
from .ops.hamming_cuda import IncrementalDeviceLibrary, banded_adjacency_cuda
from .utils.device import resolve_device
from .video_hash import VideoHash

BACKENDS = ("auto", "device", "band", "host", "naive")


class Search(_RefSearch):
    """Sorted hash store for duplicate searches, sweeping on ``device``."""

    def __init__(
        self,
        hashes: Iterable[VideoHash] = (),
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__(hashes)
        self.device = resolve_device(device)

    def seed(self, new_entries: Iterable[VideoHash]) -> None:
        super().seed(new_entries)
        # the entries were re-sorted: attach_device_library(lib, None)
        # must spot-check the library's order again
        self._ctor_resorted = None

    def _ensure_adjacency(self, tolerance_int: int, backend: str) -> None:
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

    def search_with_references_batched(
        self, references: Sequence[VideoHash], tolerance: float
    ) -> list[list[str]]:
        """Non-consuming multi-reference search, output-identical to
        ``search_one(consume=False)`` per reference
        (video_dup_finder.rs:19-46): the references, sorted by duration,
        are swept against their [0.95d, 1.05d] windows in one
        :func:`.ops.hamming.refs_adjacency` on the Search's device, over
        the attached library's rows when there is one.  Candidates already
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
        cands = self._ensure_cands_dev()
        pi, pj = refs_adjacency(
            hashes_to_matrix([refs[k] for k in order]),
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
    ``library_paths`` is None (:meth:`Search.attach_device_library`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
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
