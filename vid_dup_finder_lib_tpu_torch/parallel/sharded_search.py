"""Sharded hashing and the ring candidate scan.  Counterpart of
``vid_dup_finder_lib_tpu/parallel/sharded_search.py``.

* :func:`sharded_hash_batch`: the video batch split over the shards, each
  part hashed by :func:`..ops.hash_kernel.hash_cubes` on its shard's device
  (K1 on a card, its plain version on the CPU).
* :func:`ring_candidate_scan`: per-row statistics of the self-search
  window (match count, best distance, best index) with the library's
  column blocks moving around the ring of shards, the cheap probe of the
  JAX package.  Its distances come from a float32 matrix product of the
  +/-1 expansions, outside any kernel, as the JAX package leaves its
  ``lax.dot_general`` to XLA: every partial sum is an integer of magnitude
  at most 1024, so the product is exact in float32, also under TF32.
* :func:`banded_adjacency_ring` (in :mod:`.ring_cuda`), re-exported: the
  exact pairs over the ring, behind ``search(..., backend="ring")``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..definitions import HASH_BITS, HASH_BITS_PADDED, SELF_SEARCH_DURATION_FACTOR
from ..ops import hamming_cuda as hc
from ..ops import hash_kernel as hk
from .mesh import Mesh
from .ring_cuda import banded_adjacency_ring  # noqa: F401

SCAN_CELLS = 1 << 24  # most float32 distances of one scan chunk: 64 MiB


def sharded_hash_batch(mesh: Mesh, cubes: np.ndarray | torch.Tensor) -> np.ndarray:
    """Data-parallel batch hash over ``mesh``: uint8[B, 16, 16, 16] cubes
    (a host array, or a tensor on a device of the mesh's type) ->
    uint32[B, 32] words.  The batch is split in order, unevenly where it
    must be; a shard with no cubes launches nothing."""
    if isinstance(cubes, torch.Tensor):
        if cubes.device.type != mesh[0].type:
            raise ValueError(f"cubes lie on {cubes.device}, the mesh on {mesh[0].type}")
    else:
        cubes = torch.from_numpy(np.ascontiguousarray(cubes))
    hk._check_cubes(cubes)
    # every part is launched before any result is fetched
    outs = [hk.hash_cubes(part.to(dev)) for part, dev in zip(torch.tensor_split(cubes, mesh.size), mesh)
            if part.shape[0]]
    if not outs:
        return np.zeros((0, HASH_BITS_PADDED // 32), np.uint32)
    return torch.cat([o.cpu() for o in outs]).numpy().view(np.uint32)


def ring_candidate_scan(
    mesh: Mesh, packed: np.ndarray, durations: np.ndarray, tolerance_int: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-pairs duplicate-candidate scan sharded over ``mesh``.

    ``packed`` (uint32[n, 32]) must be sorted by duration.  Returns int32
    ``(counts, best_dist, best_idx)`` per row, over the candidates j with
    j > i, dur_j <= int(1.1 * dur_i) (the product in float32, as in the
    JAX package) and hamming <= tolerance_int (the search_self window,
    search_algorithm.rs:93-117); a row without one has best_dist 1001 and
    best_idx -1.  ``best_idx`` is the smallest j at the best distance.

    Shard d owns rows ``[d * ns, (d + 1) * ns)``, ``ns = ceil(n / n_dev)``,
    and at step s holds the column block of shard d + s, copied from shard
    d + 1 as in the ring; blocks hold real rows only, so no column is a
    pad.  Blocks behind a shard's own hold no j > i and are not visited;
    blocks are visited in ascending order, so a strictly smaller distance
    is needed to replace an earlier best.  (The JAX package rotates its
    blocks forward, so after a row's own block it meets the others from
    the last down: where the best distance ties across two blocks, it keeps
    the j of the higher block.)"""
    packed = hc._packed_rows(packed, "packed")
    n = packed.shape[0]
    durations = np.asarray(durations, dtype=np.int64)
    if durations.shape != (n,):
        raise ValueError(f"durations must be [{n}], got {durations.shape}")
    counts = np.zeros(n, np.int32)
    best_dist = np.full(n, HASH_BITS + 1, np.int32)
    best_idx = np.full(n, -1, np.int32)
    if n == 0:
        return counts, best_dist, best_idx
    # the duration threshold in float32, as the JAX package's scan takes it
    thresh = (durations.astype(np.float32) * np.float32(SELF_SEARCH_DURATION_FACTOR)).astype(np.int64)
    ns = -(-n // mesh.size)
    spans = [(a, min(a + ns, n)) for a in range(0, n, ns)]
    # each block: packed words, durations and row ids on its own shard
    parked = [
        tuple(torch.from_numpy(x[a:b]).to(dev)
              for x in (packed.view(np.int32), durations, np.arange(n)))
        for (a, b), dev in zip(spans, mesh)
    ]
    own = [(hc.pm1(blk[0]), torch.from_numpy(thresh[a:b]).to(dev), blk[2])
           for blk, (a, b), dev in zip(parked, spans, mesh)]
    stats = [[torch.zeros(b - a, dtype=torch.int32, device=dev),
              torch.full((b - a,), HASH_BITS + 1, dtype=torch.int32, device=dev),
              torch.full((b - a,), -1, dtype=torch.int64, device=dev)]
             for (a, b), dev in zip(spans, mesh)]
    for s in range(len(spans)):
        for d in range(len(spans) - s):
            words, col_durs, col_ids = parked[d]
            pm_cols = hc.pm1(words)
            pm_rows, row_thresh, row_ids = own[d]
            chunk = max(1, SCAN_CELLS // pm_cols.shape[0])
            for r0 in range(0, pm_rows.shape[0], chunk):
                r1 = r0 + chunk
                dot = pm_rows[r0:r1] @ pm_cols.T
                dist = ((HASH_BITS_PADDED - dot) * 0.5).to(torch.int32)
                valid = ((col_ids[None, :] > row_ids[r0:r1, None])
                         & (col_durs[None, :] <= row_thresh[r0:r1, None])
                         & (dist <= tolerance_int))
                cnt, best, idx = stats[d]
                cnt[r0:r1] += valid.sum(1, dtype=torch.int32)
                blk_best, arg = torch.where(valid, dist, HASH_BITS + 1).min(1)
                better = blk_best < best[r0:r1]
                idx[r0:r1] = torch.where(better, col_ids[arg], idx[r0:r1])
                best[r0:r1] = torch.minimum(best[r0:r1], blk_best)
        # backward rotation: shard d receives the block shard d + 1 holds
        parked = [tuple(x.to(mesh[d], copy=True, non_blocking=True) for x in parked[d + 1])
                  for d in range(len(spans) - s - 1)]
    for (a, b), (cnt, best, idx) in zip(spans, stats):
        counts[a:b] = cnt.cpu().numpy()
        best_dist[a:b] = best.cpu().numpy()
        best_idx[a:b] = idx.cpu().numpy()
    return counts, best_dist, best_idx
