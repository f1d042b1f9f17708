"""Re-export of ``vid_dup_finder_lib_tpu.ingest``: host-side probing and
frame decoding (no jax)."""

from vid_dup_finder_lib_tpu.ingest import *  # noqa: F401,F403
from vid_dup_finder_lib_tpu.ingest.backend import force_backend  # noqa: F401
