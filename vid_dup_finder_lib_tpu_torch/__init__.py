"""Video duplicate finder on PyTorch and CUDA.

The port of ``vid_dup_finder_lib_tpu`` (JAX/Pallas on a TPU) to PyTorch
with hand-written CUDA kernels for an NVIDIA H100.  The public surface is
the JAX package's: perceptual video hashing (16-frame grayscale 3D-DCT
sign hash) and tolerance-based duplicate search.  The package stands
alone: its host modules (definitions, errors, crop, match groups, the hash
value type, the search's sorting and greedy replay, the single-video
builder, ingest, the cache and the CLI) are copies of the JAX package's,
under the same module names.  It imports neither jax nor the JAX package.

Device entry points take a ``device`` (``None`` = the card, CUDA's
current device; the CPU only when named, ``device="cpu"``), or a tensor
or library that lies on one:

* search: ``search`` and ``search_with_references`` (both also over a
  resident library, ``device_library=`` / ``library_paths=``),
  ``ops.hamming.banded_adjacency``, ``ops.hamming.refs_adjacency``;
* the growing library: ``ops.hamming_cuda.IncrementalDeviceLibrary``
  (``append``, ``state``), ``convert.library_from_numpy``;
* hashing: ``models.pipeline.hash_videos`` (``device_preproc=``),
  ``models.pipeline.hash_raw_frames_device``, ``ops.hash_kernel.hash_cubes``;
* device preprocessing: ``ops.letterbox_device.cropdetect_letterbox_device``,
  ``ops.resize_device.resize_frames_device``;
* the hash cache ``cache.VideoHashFilesystemCache(..., device=)`` and the
  CLI, ``app.run_app(argv, device=)`` or ``python -m
  vid_dup_finder_lib_tpu_torch.app`` (device from ``VDF_TORCH_DEVICE``,
  default ``cuda``).
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

__version__ = "0.4.0"  # kept in sync with pyproject.toml


def __getattr__(name):
    # the builder pulls in the ingest stack: import it only when asked
    if name in ("VideoHashBuilder", "CreationOptions"):
        from .models import builder as _b

        return getattr(_b, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
