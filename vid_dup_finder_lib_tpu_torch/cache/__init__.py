"""Persistence: the hash cache is the framework's checkpoint/resume system.

Mirrors the reference's cache stack (SURVEY.md section 2.4): a generic
mtime-validated filesystem memoizer, specialized to ``Result<VideoHash,
Error>`` values (errors are cached so failing videos are not re-decoded
every run), with a metadata sidecar that invalidates everything when
hash-affecting settings change, crash-safe atomic saves, and periodic
autosave so an interrupted bulk hashing run resumes where it left off.

``update_using_fs`` diffs the filesystem against the cache, then hashes
all stale videos through the *batched* device pipeline of the port
(:func:`..models.pipeline.hash_videos`) on the cache's device.
"""

from .base_cache import BaseFsCache
from .filename_pattern import FilenamePattern
from .hash_cache import VideoHashFilesystemCache
from .file_content_cache import FileContentCache

__all__ = [
    "BaseFsCache",
    "FileContentCache",
    "FilenamePattern",
    "VideoHashFilesystemCache",
]
