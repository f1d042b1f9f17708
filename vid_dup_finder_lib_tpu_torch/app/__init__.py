"""Application layer on the port: CLI, config, outputs, match database
(counterpart of ``vid_dup_finder_lib_tpu.app``; ``python -m
vid_dup_finder_lib_tpu_torch.app`` hashes and searches on an explicit
device).

Mirrors the reference's ``vid_dup_finder_app`` (SURVEY.md section 2.5): the
``vid-dup-finder`` command-line tool over the library — hash cache
management, disk search, text/JSON/thumbnail outputs, and the
human-curated match database.
"""

from .app_cfg import AppCfg, Sorting
from .app_fns import run_app

__all__ = ["AppCfg", "Sorting", "run_app"]
