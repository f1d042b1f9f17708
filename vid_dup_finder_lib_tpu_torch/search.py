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
from .utils.device import resolve_device
from .video_hash import VideoHash

BACKENDS = ("auto", "device", "band", "host", "naive")

_NOT_PORTED = (
    "device-resident libraries are not ported yet (see ROADMAP.md,"
    " 'IncrementalDeviceLibrary and attach_device_library')"
)


class Search(_RefSearch):
    """Sorted hash store for duplicate searches, sweeping on ``device``."""

    def __init__(
        self,
        hashes: Iterable[VideoHash] = (),
        device: torch.device | str | None = None,
    ) -> None:
        super().__init__(hashes)
        self.device = resolve_device(device)

    def _ensure_adjacency(self, tolerance_int: int, backend: str) -> None:
        if self._adj_j is not None and self._tol_of_adjacency == tolerance_int:
            return
        pairs_i, pairs_j = banded_adjacency(
            self._packed_matrix(),
            self._self_search_bounds(),
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
        :func:`.ops.hamming.refs_adjacency` on the Search's device.
        Candidates already ``matched`` are dropped after the sweep; each
        reference's matches come in ascending candidate order, and the
        results in input order."""
        tol = _tolerance_int(tolerance)
        refs = list(references)
        if not refs or not self.entries:
            return [[] for _ in refs]
        order = sorted(range(len(refs)), key=lambda k: refs[k].duration)
        windows = np.array(
            [self._duration_slice(refs[k].duration) for k in order], np.int64
        )
        pi, pj = refs_adjacency(
            hashes_to_matrix([refs[k] for k in order]),
            self._packed_matrix(),
            windows[:, 0],
            windows[:, 1],
            tol,
            device=self.device,
        )
        keep = ~self.matched[pj]
        results: list[list[str]] = [[] for _ in refs]
        for i, j in zip(pi[keep].tolist(), pj[keep].tolist()):
            results[order[i]].append(self.entries[j].src_path)
        return results

    def attach_device_library(self, library, insertion_paths, geom=None):
        raise NotImplementedError(_NOT_PORTED)

    @staticmethod
    def _library_rows(library, idx):
        raise NotImplementedError(_NOT_PORTED)

    def _ensure_cands_dev(self):
        raise NotImplementedError(_NOT_PORTED)


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
) -> list[MatchGroup]:
    """Groups of mutual duplicates within ``hashes``
    (``vid_dup_finder_lib::search``); ``tolerance`` in [0, 1]."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if tolerance is None:
        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(hashes, device=device)
    return _groups(s.search_self(tolerance, backend=backend))


def search_with_references(
    ref_hashes: Iterable[VideoHash],
    new_hashes: Iterable[VideoHash],
    tolerance: float | None = None,
    device: torch.device | str | None = None,
) -> list[MatchGroup]:
    """Per reference video, its duplicates among ``new_hashes``
    (``vid_dup_finder_lib::search_with_references``), non-consuming.  From
    64 references up, one batched sweep on ``device``
    (:meth:`Search.search_with_references_batched`); below that, one
    reference at a time on the host, as the JAX package does."""
    if tolerance is None:
        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(new_hashes, device=device)
    refs = list(ref_hashes)
    if len(refs) >= _BATCHED_REFS_THRESHOLD:
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
