"""Multi-device references search: the references sharded over a mesh.
Counterpart of ``vid_dup_finder_lib_tpu/parallel/refs_sharded.py``
(``refs_adjacency_sharded``).

The duration-sorted references are split contiguously over the shards
(``refs_sharded.py:87-96``), so each shard's candidate windows form a
contiguous slab of the sorted candidates.  The packed candidates are
replicated once per distinct device (128 B per hash); a shard on the device
that already holds them resident uses them as they are.  Each shard runs
K2 + K3 in their window mode (:class:`..ops.hamming_cuda.RefsState`,
``refs_adjacency_cuda``, in slabs under the counts budget); no data moves
between shards after the replication.  The shards of one card run in turn,
those of distinct cards at once (:func:`.mesh.run_by_device`).

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
from .ring_cuda import shard_rows


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

    replicas = {}  # the candidates once per distinct device that sweeps
    r_sh = shard_rows(r, mesh.size)

    def sweep(d):
        dev, a, b = mesh[d], d * r_sh, min((d + 1) * r_sh, r)
        if dev not in replicas:  # a device's jobs run in turn, in one thread
            if cands is None:
                replicas[dev] = hc._tiled(cands_packed, dev)
            else:
                replicas[dev] = cands if cands.device == dev else cands.to(dev, copy=True)
        state = hc.RefsState(refs_packed[a:b], replicas[dev], lo[a:b], hi[a:b], dev, n_cands=n)
        ii, jj = hc.refs_adjacency_cuda(state, tolerance_int, counts_budget)
        return ii + a, jj

    out = run_by_device([(mesh[d], lambda d=d: sweep(d))
                         for d in range(mesh.size) if d * r_sh < r])
    # each shard's pairs are sorted and the shards' rows ascend: the
    # concatenation is in lexicographic order
    return np.concatenate([o[0] for o in out]), np.concatenate([o[1] for o in out])
