"""mtime-validated memoizer layered on BaseFsCache.

Semantics follow the reference's ``ProcessingFsCache``
(``…/generic_filesystem_cache/processing_fs_cache.rs``): each entry stores
the source file's mtime; ``fetch_update`` decides NoChange / Update / Remove
by comparing whole-second mtimes with a +/-2 s tolerance (:149-199, an SSHFS
workaround), re-running the processing function only when stale.
"""

from __future__ import annotations

import enum
import os
from typing import Callable

from .base_cache import BaseFsCache

MTIME_TOLERANCE_SECS = 2


class UpdateAction(enum.Enum):
    NO_CHANGE = "no_change"
    UPDATE = "update"
    REMOVE = "remove"


def mtime_secs(path: str) -> int | None:
    try:
        return int(os.stat(path).st_mtime)
    except OSError:
        return None


def mtimes_match(a: int | None, b: int | None) -> bool:
    if a is None or b is None:
        return False
    return abs(a - b) <= MTIME_TOLERANCE_SECS


class ProcessingFsCache:
    """Entries are (mtime, value); ``load_fn(path) -> value`` is the plug
    point (the reference's ``CacheInterface::load``, generic_cache_if.rs)."""

    def __init__(
        self,
        cache_path: str | os.PathLike,
        load_fn: Callable[[str], object],
        save_threshold: int = 0,
        encode: Callable = lambda v: v,
        decode: Callable = lambda v: v,
    ) -> None:
        self._load_fn = load_fn
        self._cache = BaseFsCache(
            cache_path,
            save_threshold=save_threshold,
            encode=lambda mv: {"mtime": mv[0], "value": encode(mv[1])},
            decode=lambda raw: (raw["mtime"], decode(raw["value"])),
        )

    # -- decisions ---------------------------------------------------------

    def plan_update(self, key: str) -> UpdateAction:
        fs_mtime = mtime_secs(key)
        if fs_mtime is None:
            return (
                UpdateAction.REMOVE
                if self._cache.contains_key(key)
                else UpdateAction.NO_CHANGE
            )
        if not self._cache.contains_key(key):
            return UpdateAction.UPDATE
        cached_mtime, _ = self._cache.get(key)
        if mtimes_match(cached_mtime, fs_mtime):
            return UpdateAction.NO_CHANGE
        return UpdateAction.UPDATE

    # -- operations --------------------------------------------------------

    def fetch(self, key: str):
        return self._cache.get(key)[1]

    def contains_key(self, key: str) -> bool:
        return self._cache.contains_key(key)

    def fetch_update(self, key: str):
        action = self.plan_update(key)
        if action is UpdateAction.REMOVE:
            self._cache.remove(key)
            raise KeyError(key)
        if action is UpdateAction.UPDATE:
            self.force_update(key)
        return self.fetch(key)

    def force_update(self, key: str) -> None:
        value = self._load_fn(key)
        self.insert_with_mtime(key, value, mtime_secs(key) or 0)

    def insert_with_mtime(self, key: str, value, mtime: int) -> None:
        self._cache.insert(key, (mtime, value))

    def remove(self, key: str) -> None:
        self._cache.remove(key)

    def keys(self) -> list[str]:
        return self._cache.keys()

    def save(self) -> None:
        self._cache.save()

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)
