"""``python -m vid_dup_finder_lib_tpu_torch.app`` — the vid-dup-finder CLI
on the port.

The device comes from ``VDF_TORCH_DEVICE`` (default ``cuda``); without
CUDA the run raises unless ``VDF_TORCH_DEVICE=cpu`` is set: it never
moves to the CPU on its own.
"""

import os
import sys

from .app_fns import run_app

if __name__ == "__main__":
    sys.exit(run_app(device=os.environ.get("VDF_TORCH_DEVICE", "cuda")))
