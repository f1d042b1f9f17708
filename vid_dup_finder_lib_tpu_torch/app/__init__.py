"""Application layer on the port: the ``vid-dup-finder`` CLI hashing and
searching on an explicit device (``python -m vid_dup_finder_lib_tpu_torch.app``).

Configuration, outputs and the match database are the JAX package's
(``vid_dup_finder_lib_tpu.app``); :func:`.app_fns.run_app` is the port's.
"""

from vid_dup_finder_lib_tpu.app.app_cfg import AppCfg, Sorting

from .app_fns import run_app

__all__ = ["AppCfg", "Sorting", "run_app"]
