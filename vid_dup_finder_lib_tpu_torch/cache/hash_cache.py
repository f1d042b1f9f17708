"""The video-hash filesystem cache, hashing on the port's device
(counterpart of ``vid_dup_finder_lib_tpu/cache/hash_cache.py``).

Mirrors the reference's ``VideoHashFilesystemCache``
(``…/video_hash_filesystem_cache.rs``):

* values are ``Result<VideoHash, Error>`` — errors are cached so a broken
  video is not re-decoded on every run (generic_cache_if.rs:22-44), with
  explicit re-try via ``reload_errors``;
* a metadata sidecar records the hash-affecting settings (decode backend,
  cropdetect, skip_forward, hash duration, cache version) and the cache
  refuses to open when they differ (:76-139, cache_metadata.rs:127-162);
* autosave every ``save_threshold`` mutations makes the cache the
  checkpoint: an interrupted bulk run resumes where it stopped.

One video hashes through :func:`..ops.hash_kernel.hash_cubes`, stale
videos in batches through :func:`..models.pipeline.hash_videos`, both on
the cache's explicit ``device``.  The file format and the sidecar are the
JAX package's byte for byte, so a cache written by either package is read
and updated by the other.
"""

from __future__ import annotations

import json
import os
import platform
from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np
import torch

from ..errors import VdfError
from ..models.builder import CreationOptions
from ..models.pipeline import hash_videos, safe_prepare
from ..ops.hash_kernel import hash_cubes
from ..utils.device import resolve_device
from ..video_hash import VideoHash
from .processing_cache import ProcessingFsCache, UpdateAction, mtime_secs

CACHE_VERSION = 1
HASH_BATCH = 256


class VdfCacheError(Exception):
    pass


def _encode_value(v) -> dict:
    if isinstance(v, VideoHash):
        return {"ok": v.to_json()}
    return {"err": v.to_json()}


def _decode_value(raw: dict):
    if "ok" in raw:
        return VideoHash.from_json(raw["ok"])
    return VdfError.from_json(raw["err"])


@dataclass(frozen=True)
class CacheMetadata:
    """Sidecar contents (cache_metadata.rs:80-126)."""

    cache_version: int
    os_name: str
    decode_backend: str
    cropdetect: str
    skip_forward: float
    hash_duration: float

    @staticmethod
    def current(opts: CreationOptions) -> "CacheMetadata":
        from ..ingest.backend import active_backend_name

        return CacheMetadata(
            cache_version=CACHE_VERSION,
            os_name=platform.system(),
            # the backend decodes will ACTUALLY use (force_backend
            # honored) — recording available_backends()[0] let a pinned
            # run mix decode backends into a cache that validated clean
            decode_backend=active_backend_name(),
            cropdetect=opts.cropdetect.value,
            skip_forward=opts.skip_forward_amount,
            hash_duration=opts.duration,
        )

    def validate_against(self, other: "CacheMetadata") -> None:
        if self != other:
            raise VdfCacheError(
                "hash cache was created with different settings "
                f"(cached={other}, current={self}); delete the cache or "
                "use matching settings"
            )


class VideoHashFilesystemCache:
    """The hash cache, hashing on ``device`` (``None``: PyTorch's default
    device)."""

    def __init__(
        self,
        cache_path: str | os.PathLike,
        save_threshold: int = 0,
        creation_options: CreationOptions = CreationOptions(),
        device: torch.device | str | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.cache_path = os.fspath(cache_path)
        self.options = creation_options
        self._meta_path = (
            os.path.splitext(self.cache_path)[0] + ".metadata.json"
        )
        self._check_or_write_metadata()
        self._cache = ProcessingFsCache(
            self.cache_path,
            load_fn=self._load_one,
            save_threshold=save_threshold,
            encode=_encode_value,
            decode=_decode_value,
        )

    # -- metadata sidecar --------------------------------------------------

    def _check_or_write_metadata(self) -> None:
        current = CacheMetadata.current(self.options)
        if os.path.exists(self._meta_path):
            with open(self._meta_path, "r", encoding="utf-8") as f:
                raw = json.load(f)
            try:
                stored = CacheMetadata(**raw)
            except TypeError:
                # schema drift (the very case cache_version exists for)
                # must surface as the clean mismatch error, not TypeError
                raise VdfCacheError(
                    "hash cache metadata has an incompatible schema "
                    f"({raw}); delete the cache or use a matching version"
                ) from None
            current.validate_against(stored)
        else:
            os.makedirs(
                os.path.dirname(os.path.abspath(self._meta_path)),
                exist_ok=True,
            )
            with open(self._meta_path, "w", encoding="utf-8") as f:
                json.dump(current.__dict__, f, indent=2)

    # -- single-video load (the CacheInterface::load equivalent) ------------

    def _load_one(self, path: str):
        """Hash one video; errors become cached values, not exceptions."""
        _, cube, duration, err = safe_prepare(path, self.options)
        if err is not None:
            return err
        cubes = torch.from_numpy(np.ascontiguousarray(cube[None])).to(self.device)
        packed = hash_cubes(cubes).cpu().numpy().view(np.uint32)[0]
        return VideoHash.from_packed_u32(packed, path, duration)

    # -- fetch API (video_hash_filesystem_cache.rs:146-269) -----------------

    def fetch(self, path: str) -> VideoHash:
        """Cached value; raises the cached error for error entries."""
        value = self._cache.fetch(os.fspath(path))
        if isinstance(value, VdfError):
            raise value
        return value

    def fetch_update(self, path: str) -> VideoHash:
        value = self._cache.fetch_update(os.fspath(path))
        if isinstance(value, VdfError):
            raise value
        return value

    def force_update(self, path: str) -> None:
        self._cache.force_update(os.fspath(path))

    def contains(self, path: str) -> bool:
        return self._cache.contains_key(os.fspath(path))

    def all_cached_paths(self) -> list[str]:
        return [
            k
            for k in self._cache.keys()
            if not isinstance(self._cache.fetch(k), VdfError)
        ]

    def error_paths(self) -> list[str]:
        return [
            k
            for k in self._cache.keys()
            if isinstance(self._cache.fetch(k), VdfError)
        ]

    def fetch_hashes(self, paths: Iterable[str]) -> list[VideoHash]:
        out = []
        for p in paths:
            try:
                out.append(self.fetch(p))
            except (KeyError, VdfError):
                pass
        return out

    def remove(self, path: str) -> None:
        self._cache.remove(os.fspath(path))

    def save(self) -> None:
        self._cache.save()

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)

    # -- batched update ----------------------------------------------------

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
        of (re)hashed videos (video_hash_filesystem_cache.rs:236-257)."""
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

    def prune_deleted(self) -> int:
        """Drop entries whose source file no longer exists
        (app_fns.rs:826-845)."""
        gone = [p for p in self._cache.keys() if not os.path.exists(p)]
        for p in gone:
            self._cache.remove(p)
        return len(gone)
