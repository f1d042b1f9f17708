"""Re-export of ``vid_dup_finder_lib_tpu.match_group`` (host-only, no jax): the port
shares its semantics by construction."""

from vid_dup_finder_lib_tpu.match_group import *  # noqa: F401,F403
