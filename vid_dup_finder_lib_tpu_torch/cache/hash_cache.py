"""The video-hash filesystem cache, hashing on the port's device.

``VideoHashFilesystemCache`` subclasses the JAX package's class and
replaces only what hashes: :meth:`_load_one` (one video, through
:func:`..ops.hash_kernel.hash_cubes`) and :meth:`update_using_fs` (stale
videos in batches, through :func:`..models.pipeline.hash_videos`), both on
an explicit ``device``.  The file format, the metadata sidecar, the mtime
rules and the autosave checkpoint are the JAX package's, so a cache
written by either package is read and updated by the other.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from vid_dup_finder_lib_tpu.cache.hash_cache import (
    HASH_BATCH,
    VdfCacheError,
)
from vid_dup_finder_lib_tpu.cache.hash_cache import (
    VideoHashFilesystemCache as _RefCache,
)
from vid_dup_finder_lib_tpu.cache.processing_cache import UpdateAction, mtime_secs

from ..errors import VdfError, VidProc
from ..models.builder import CreationOptions, prepare_frames
from ..models.pipeline import hash_videos
from ..ops.hash_kernel import hash_cubes
from ..utils.device import resolve_device
from ..video_hash import VideoHash

__all__ = ["HASH_BATCH", "VdfCacheError", "VideoHashFilesystemCache"]


class VideoHashFilesystemCache(_RefCache):
    """The hash cache of ``vid_dup_finder_lib_tpu.cache``, hashing on
    ``device`` (``None``: PyTorch's default device)."""

    def __init__(
        self,
        cache_path: str | os.PathLike,
        save_threshold: int = 0,
        creation_options: CreationOptions = CreationOptions(),
        device: torch.device | str | None = None,
    ) -> None:
        self.device = resolve_device(device)
        super().__init__(cache_path, save_threshold, creation_options)

    def _load_one(self, path: str):
        """Hash one video; errors become cached values, not exceptions."""
        try:
            cube, duration = prepare_frames(path, self.options)
        except VdfError as e:
            return e
        except Exception as e:  # decode libraries can throw anything
            return VidProc(f"{e!r}")
        cubes = torch.from_numpy(np.ascontiguousarray(cube[None])).to(self.device)
        packed = hash_cubes(cubes).cpu().numpy().view(np.uint32)[0]
        return VideoHash.from_packed_u32(packed, path, duration)

    def update_using_fs(
        self,
        paths: Iterable[str],
        reload_errors: bool = False,
        decode_workers: int = 8,
        progress: Callable[[int, int], None] | None = None,
        device_preproc: bool | None = None,
    ) -> int:
        """Bring the cache up to date for ``paths``: new and stale videos
        (and, with ``reload_errors``, cached errors) are hashed in chunks
        of ``HASH_BATCH`` through ``hash_videos`` on the cache's device,
        host or device preprocessing as ``device_preproc`` says (default:
        ``VDF_DEVICE_PREPROC``).  Each chunk is inserted before the next
        is decoded, so the autosave checkpoint holds.  Returns the number
        of (re)hashed videos."""
        paths = [os.fspath(p) for p in paths]
        stale: list[str] = []
        for p in paths:
            action = self._cache.plan_update(p)
            if action is UpdateAction.REMOVE:
                self._cache.remove(p)
            elif action is UpdateAction.UPDATE:
                stale.append(p)
            elif reload_errors and self._cache.contains_key(p) and isinstance(
                self._cache.fetch(p), VdfError
            ):
                stale.append(p)

        for start in range(0, len(stale), HASH_BATCH):
            chunk = stale[start : start + HASH_BATCH]
            # mtimes before decoding: a file modified mid-hash must look
            # stale on the next run, not fresh with old bits
            mtimes = {p: mtime_secs(p) or 0 for p in chunk}
            res = hash_videos(
                chunk,
                self.options,
                decode_workers=decode_workers,
                device=self.device,
                device_preproc=device_preproc,
            )
            for p in chunk:
                self._cache.insert_with_mtime(p, res[p], mtimes[p])
            if progress:
                progress(start + len(chunk), len(stale))
        return len(stale)
