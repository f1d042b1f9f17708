"""Re-export of ``vid_dup_finder_lib_tpu.ops.golden``, the f64 NumPy model
of the hash pipeline that every hash kernel is held to (no jax)."""

from vid_dup_finder_lib_tpu.ops.golden import *  # noqa: F401,F403
