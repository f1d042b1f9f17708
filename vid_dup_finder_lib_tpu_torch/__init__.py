"""Video duplicate finder on PyTorch and CUDA.

The port of ``vid_dup_finder_lib_tpu`` (JAX/Pallas on a TPU) to PyTorch
with hand-written CUDA kernels for an NVIDIA H100.  The public surface is
the JAX package's: perceptual video hashing (16-frame grayscale 3D-DCT
sign hash) and tolerance-based duplicate search.  Host-only modules
(definitions, errors, crop, match groups, the hash value type, the
single-video builder, ingest) are the JAX package's own, imported rather
than copied; none of them imports jax.  This package never imports jax.

Device entry points take an explicit ``device`` (``None`` = PyTorch's
default device): ``search``, ``search_with_references``,
``models.pipeline.hash_videos``, ``ops.hash_kernel.hash_cubes``,
``ops.hamming.banded_adjacency``, ``ops.hamming.refs_adjacency``.
"""

from .crop import Crop
from .definitions import (
    DCT_SIZE,
    DEFAULT_SEARCH_TOLERANCE,
    DEFAULT_VID_HASH_DURATION,
    DEFAULT_VID_HASH_SKIP_FORWARD,
    HASH_BITS,
    HASH_SIZE,
    TOLERANCE_SCALING_FACTOR,
    Cropdetect,
)
from .errors import NotEnoughFrames, NotVideo, VdfError, VidProc
from .match_group import MatchGroup, TooFewEntries
from .search import Search, search, search_with_references
from .video_hash import VideoHash, VideoHashBatch

__all__ = [
    "Crop",
    "Cropdetect",
    "CreationOptions",
    "DCT_SIZE",
    "DEFAULT_SEARCH_TOLERANCE",
    "DEFAULT_VID_HASH_DURATION",
    "DEFAULT_VID_HASH_SKIP_FORWARD",
    "HASH_BITS",
    "HASH_SIZE",
    "MatchGroup",
    "NotEnoughFrames",
    "NotVideo",
    "Search",
    "TOLERANCE_SCALING_FACTOR",
    "TooFewEntries",
    "VdfError",
    "VideoHash",
    "VideoHashBatch",
    "VideoHashBuilder",
    "VidProc",
    "search",
    "search_with_references",
]


def __getattr__(name):
    # the builder pulls in the ingest stack: import it only when asked
    if name in ("VideoHashBuilder", "CreationOptions"):
        from .models import builder as _b

        return getattr(_b, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
