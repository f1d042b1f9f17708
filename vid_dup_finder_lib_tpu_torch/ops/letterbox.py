"""Re-export of ``vid_dup_finder_lib_tpu.ops.letterbox``, the host letterbox
detection that :mod:`.letterbox_device` is held to (NumPy only, no jax)."""

from vid_dup_finder_lib_tpu.ops.letterbox import *  # noqa: F401,F403
from vid_dup_finder_lib_tpu.ops.letterbox import cropdetect_letterbox  # noqa: F401
