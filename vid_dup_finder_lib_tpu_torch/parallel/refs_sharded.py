"""Multi-device references search: the references sharded over a mesh.
Counterpart of ``vid_dup_finder_lib_tpu/parallel/refs_sharded.py``
(``refs_adjacency_sharded``).

The duration-sorted references are split contiguously over the shards
(``refs_sharded.py:87-96``), so each shard's candidate windows form a
contiguous slab of the sorted candidates.  The cuts fall at equal window
pairs (:func:`.ring_cuda.work_cuts` over ``hi - lo``, each reference also
counted once), rounded to the 128-row tile, where the JAX package cuts
equal row blocks: a longer reference has a wider window.  The packed
candidates are replicated once per distinct device (128 B per hash): they
go up once, to the device that holds them resident or else the first
device of the mesh, and from there card to card on copy streams
(:func:`.ring_cuda.copy_after`).  Each shard runs K2 + K3 in their window
mode (:class:`..ops.hamming_cuda.RefsState`, ``refs_adjacency_cuda``, in
slabs under the counts budget), after the event behind its card's
replica; no data moves between shards after the replication.  The shards
of one card run in turn, those of distinct cards at once, one job per
card (:func:`.mesh.run_by_device`).

Not ported, for the reasons of ``ring_cuda``'s docstring: the sliding
+/-1 column window (``_window_jits``, ``VDF_REFS_WINDOW_ROWS``), the
extraction-overflow fallback ``_host_refs_launch`` and the host +/-1
expansion ``_unpack_host_free``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming_cuda as hc
from .mesh import Mesh, make_mesh, run_by_device
from .ring_cuda import copy_after, copy_streams, work_cuts


def refs_adjacency_sharded(
    refs_packed: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    cands_packed: np.ndarray | None = None,
    cands_dev: torch.Tensor | None = None,
    n_cands: int | None = None,
    mesh: Mesh | None = None,
    counts_budget: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j): i a row of ``refs_packed`` (uint32[r, 32],
    duration-sorted), ``lo[i] <= j < hi[i]``, hamming <= tolerance_int, as
    int64 NumPy arrays in lexicographic order: the contract of
    ``ops.hamming.refs_adjacency``, computed with the references sharded
    over ``mesh``.  The candidates are ``cands_packed`` (host uint32[n,
    32]) or ``cands_dev`` (a resident int32[>= n_pad, 32] tensor with
    ``n_cands`` rows first); ``mesh`` defaults to :func:`.mesh.make_mesh`
    on ``cands_dev``'s device, or on the card."""
    refs_packed = hc._packed_rows(refs_packed, "refs_packed")
    if (cands_dev is None) == (cands_packed is None):
        raise ValueError("pass exactly one of cands_packed and cands_dev")
    if mesh is None:
        mesh = make_mesh(device=None if cands_dev is None else cands_dev.device)
    if cands_dev is not None:
        if cands_dev.device.type != mesh[0].type:
            raise ValueError(f"cands_dev lies on {cands_dev.device}, the mesh on {mesh[0].type}")
        cands, n = hc._matrix(cands_dev, n_cands, cands_dev.device, "cands_dev")
    else:
        cands_packed = hc._packed_rows(cands_packed, "cands_packed")
        cands, n = None, cands_packed.shape[0]
    r = refs_packed.shape[0]
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    if lo.shape != (r,) or hi.shape != (r,):
        raise ValueError(f"lo and hi must be [{r}], got {lo.shape} and {hi.shape}")
    if r == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    cuts = work_cuts(np.maximum(hi - lo, 0) + 1, mesh.size)
    shards = range(len(cuts) - 1)
    devices = list(dict.fromkeys(mesh[d] for d in shards))
    if cands is None:
        cands = hc._tiled(cands_packed, devices[0])
    streams = copy_streams(devices + [cands.device])
    replicas = {dev: (cands, None) if dev == cands.device else copy_after(cands, None, dev, streams)
                for dev in devices}

    def sweep(d):
        dev, a, b = mesh[d], int(cuts[d]), int(cuts[d + 1])
        block, arrived = replicas[dev]
        if arrived is not None:  # this card's stream waits for its replica
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(arrived)
            block.record_stream(stream)
        state = hc.RefsState(refs_packed[a:b], block, lo[a:b], hi[a:b], block.device, n_cands=n)
        ii, jj = hc.refs_adjacency_cuda(state, tolerance_int, counts_budget)
        return ii + a, jj

    out = run_by_device([(mesh[d], lambda d=d: sweep(d)) for d in shards])
    # each shard's pairs are sorted and the shards' rows ascend: the
    # concatenation is in lexicographic order
    return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])
