"""Logging setup.

Equivalent of the reference's ``configure_logs`` (app_fns.rs:868-888):
stderr logging with --quiet/--verbose levels (WARN / INFO / TRACE->DEBUG)
and suppression of the chatty per-insert cache logger target.
"""

from __future__ import annotations

import logging
import sys


def configure_logs(verbosity: str = "default") -> None:
    level = {
        "quiet": logging.WARNING,
        "default": logging.INFO,
        "verbose": logging.DEBUG,
    }.get(verbosity, logging.INFO)
    logging.basicConfig(
        stream=sys.stderr,
        level=level,
        format="%(asctime)s [%(levelname)s] (%(name)s) %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )
    # the reference filters out the generic_cache_insert target
    logging.getLogger("generic_cache_insert").setLevel(logging.WARNING)
