"""Duplicate search on the port: ``search`` / ``search_with_references``.

``Search`` subclasses the JAX package's ``Search`` and overrides only how
the duration-banded adjacency is computed (``_ensure_adjacency``), which
it routes through :func:`.ops.hamming.banded_adjacency` on the Search's
device.  Sorting, windows and the greedy replay of the reference's
consume order are the JAX package's own code, so groups match it by
construction.

Backends of ``search``:

* ``"auto"``: below 4096 entries the reference's pairwise loop, above it
  the adjacency on ``device``;
* ``"device"``: the adjacency on ``device`` at any size;
* ``"host"``: the adjacency from the JAX package's NumPy sweep;
* ``"naive"``: the pairwise loop at any size.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from vid_dup_finder_lib_tpu.search import Search as _RefSearch

from .definitions import DEFAULT_SEARCH_TOLERANCE
from .match_group import MatchGroup, TooFewEntries
from .ops.hamming import banded_adjacency
from .utils.device import resolve_device
from .video_hash import VideoHash

BACKENDS = ("auto", "device", "host", "naive")

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
            backend="host" if backend == "host" else "device",
            device=self.device,
        )
        # pairs are lexsorted by (i, j): CSR by one searchsorted
        self._adj_j = pairs_j
        self._adj_off = np.searchsorted(pairs_i, np.arange(len(self.entries) + 1))
        self._tol_of_adjacency = tolerance_int

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
) -> list[MatchGroup]:
    """Per reference video, its duplicates among ``new_hashes``
    (``vid_dup_finder_lib::search_with_references``): one reference at a
    time, non-consuming, on the host.  The device path is not ported yet
    (ROADMAP.md)."""
    if tolerance is None:
        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(new_hashes, device="cpu")
    out: list[MatchGroup] = []
    for ref in ref_hashes:
        matches = s.search_with_references([ref], tolerance, consume=False)[0]
        if matches:
            try:
                out.append(MatchGroup.new_with_reference(ref.src_path, matches))
            except TooFewEntries:
                pass
    return out
