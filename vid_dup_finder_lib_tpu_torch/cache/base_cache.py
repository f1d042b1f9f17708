"""Generic persistent map with crash-safe saves.

Semantics follow the reference's ``BaseFsCache``
(``vid_dup_finder_app/src/video_hash_filesystem_cache/generic_filesystem_cache/
base_fs_cache.rs``): an in-memory dict persisted as a single file, written
atomically (tmp file + fsync + rename, :81-164), with autosave every
``save_threshold`` mutations (:254-270).  Values are JSON-serializable via
pluggable encode/decode hooks.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Callable, Iterator


class CacheError(Exception):
    pass


class BaseFsCache:
    def __init__(
        self,
        cache_path: str | os.PathLike,
        save_threshold: int = 0,
        encode: Callable = lambda v: v,
        decode: Callable = lambda v: v,
    ) -> None:
        self.cache_path = os.fspath(cache_path)
        self.save_threshold = save_threshold
        self._encode = encode
        self._decode = decode
        self._lock = threading.RLock()
        self._map: dict[str, object] = {}
        self._mutations_since_save = 0
        if os.path.exists(self.cache_path):
            self._load()
        else:
            os.makedirs(
                os.path.dirname(os.path.abspath(self.cache_path)),
                exist_ok=True,
            )
            self.save()

    def _load(self) -> None:
        with open(self.cache_path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        self._map = {k: self._decode(v) for k, v in raw.items()}

    def save(self) -> None:
        """Atomic save: tmp file in the same dir + fsync + rename."""
        with self._lock:
            raw = {k: self._encode(v) for k, v in self._map.items()}
            d = os.path.dirname(os.path.abspath(self.cache_path))
            fd, tmp = tempfile.mkstemp(
                dir=d, prefix=".vdf_cache_", suffix=".tmp"
            )
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(raw, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.cache_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._mutations_since_save = 0

    def _mutated(self) -> None:
        # autosave cadence; a benign save-twice race is acceptable in the
        # reference too (base_fs_cache.rs:254-270)
        self._mutations_since_save += 1
        if (
            self.save_threshold
            and self._mutations_since_save >= self.save_threshold
        ):
            self.save()

    def insert(self, key: str, value) -> None:
        with self._lock:
            self._map[key] = value
            self._mutated()

    def get(self, key: str):
        with self._lock:
            if key not in self._map:
                raise KeyError(key)
            return self._map[key]

    def contains_key(self, key: str) -> bool:
        with self._lock:
            return key in self._map

    def remove(self, key: str) -> None:
        with self._lock:
            self._map.pop(key, None)
            self._mutated()

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._map.keys())

    def items(self) -> Iterator[tuple[str, object]]:
        with self._lock:
            return iter(list(self._map.items()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._mutated()
