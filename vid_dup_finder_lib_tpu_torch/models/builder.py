"""Re-export of ``vid_dup_finder_lib_tpu.models.builder``: the single-video
host path (``prepare_frames``, ``CreationOptions``, ``VideoHashBuilder``),
which imports no jax."""

from vid_dup_finder_lib_tpu.models.builder import *  # noqa: F401,F403
