"""The hash cache (counterpart of ``vid_dup_finder_lib_tpu.cache``).

Only the video-hash cache hashes, so only it is the port's own
(:class:`.hash_cache.VideoHashFilesystemCache`, on an explicit device);
the generic caches and the filename pattern are the JAX package's, which
import no jax.
"""

from vid_dup_finder_lib_tpu.cache.base_cache import BaseFsCache
from vid_dup_finder_lib_tpu.cache.file_content_cache import FileContentCache
from vid_dup_finder_lib_tpu.cache.filename_pattern import FilenamePattern

from .hash_cache import VideoHashFilesystemCache

__all__ = [
    "BaseFsCache",
    "FileContentCache",
    "FilenamePattern",
    "VideoHashFilesystemCache",
]
