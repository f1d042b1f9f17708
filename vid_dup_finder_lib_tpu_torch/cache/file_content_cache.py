"""Content-hash cache for file-identity tracking.

Equivalent of the reference's blake3-keyed ``FileContentCache``
(``…/file_hash_filesystem_cache.rs:39-237``), used by the match database to
re-link files that moved on disk.  The digest is blake3 when the module is
available, else hashlib's blake2b; digests are stored "algo:hex" so a
cache written where blake3 exists read where it doesn't is an explicit
algorithm mismatch (the entry refreshes) rather than a silent never-equal
comparison.  Legacy bare-hex entries are treated as the current algorithm.
"""

from __future__ import annotations

import hashlib
import os

from .processing_cache import ProcessingFsCache

try:
    import blake3  # type: ignore

    _ALGO = "blake3"
except ImportError:
    _ALGO = "blake2b"


def hash_file_contents(path: str) -> str:
    h = (
        blake3.blake3()  # type: ignore[name-defined]
        if _ALGO == "blake3"
        else hashlib.blake2b(digest_size=32)
    )
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return f"{_ALGO}:{h.hexdigest()}"


def canonical_digest(d: str) -> str:
    """Normalize to "algo:hex" (legacy bare-hex entries predate the tag
    and are attributed to the CURRENT algorithm): digest comparisons and
    lookups must go through this so mixed old/new caches keep matching."""
    return d if ":" in d else f"{_ALGO}:{d}"


class FileContentCache:
    """mtime-validated content digests keyed by path."""

    def __init__(
        self, cache_path: str | os.PathLike, save_threshold: int = 0
    ) -> None:
        self._cache = ProcessingFsCache(
            cache_path,
            load_fn=hash_file_contents,
            save_threshold=save_threshold,
        )

    def fetch(self, path: str) -> str:
        return self._cache.fetch_update(os.fspath(path))

    def contains(self, path: str) -> bool:
        return self._cache.contains_key(os.fspath(path))

    def keys(self) -> list[str]:
        return self._cache.keys()

    def remove(self, path: str) -> None:
        self._cache.remove(os.fspath(path))

    def save(self) -> None:
        self._cache.save()

    @staticmethod
    def algorithm() -> str:
        return _ALGO
