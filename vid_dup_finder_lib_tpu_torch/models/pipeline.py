"""Batched streaming hash pipeline (counterpart of
``vid_dup_finder_lib_tpu/models/pipeline.py``'s ``hash_videos``).

A host thread pool decodes, crops and resizes videos into 16x16x16 cubes
(the JAX package's ``safe_prepare``); each batch of cubes goes to the
device from pinned memory without blocking and through
:func:`..ops.hash_kernel.hash_cubes`.  Kernel launches are asynchronous,
so batch k hashes while batch k+1 decodes; the packed hashes (128 B per
video) come back once the pool has drained.

Device-side preprocessing (``device_preproc``) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np
import torch

from vid_dup_finder_lib_tpu.models.pipeline import DEFAULT_BATCH, safe_prepare

from ..errors import VdfError
from ..ops.hash_kernel import hash_cubes
from ..utils.device import resolve_device
from ..video_hash import VideoHash
from .builder import CreationOptions


def hash_videos(
    paths: Iterable[str],
    options: CreationOptions = CreationOptions(),
    batch_size: int = DEFAULT_BATCH,
    decode_workers: int = 8,
    progress: Callable[[int, int], None] | None = None,
    device: torch.device | str | None = None,
) -> dict[str, VideoHash | VdfError]:
    """Hash many videos on ``device``; returns {path: VideoHash | VdfError}.

    Decode errors become values (the cache stores them), not exceptions."""
    dev = resolve_device(device)
    paths = [os.fspath(p) for p in paths]
    results: dict[str, VideoHash | VdfError] = {}

    def dispatch(batch):
        metas = [(p, dur) for (p, _, dur, _) in batch]
        # prepared cubes are transposed views; np.stack keeps their strides
        cubes = torch.from_numpy(
            np.ascontiguousarray(np.stack([c for (_, c, _, _) in batch]))
        )
        if dev.type == "cuda":
            cubes = cubes.pin_memory().to(dev, non_blocking=True)
        return metas, hash_cubes(cubes)

    pending: list[tuple[list, torch.Tensor]] = []
    buf: list = []
    done = 0
    total = len(paths)
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        # pool.map yields in order while decoding ahead, so the decode of
        # batch k+1 overlaps the device hash of batch k
        for item in pool.map(lambda p: safe_prepare(p, options), paths):
            p, _, _, err = item
            done += 1
            if err is not None:
                results[p] = err
            else:
                buf.append(item)
                if len(buf) >= batch_size:
                    pending.append(dispatch(buf))
                    buf = []
            if progress:
                progress(done, total)
        if buf:
            pending.append(dispatch(buf))

    for metas, words in pending:
        rows = words.cpu().numpy().view(np.uint32)
        for (p, dur), row in zip(metas, rows):
            results[p] = VideoHash.from_packed_u32(row, p, dur)
    return results
