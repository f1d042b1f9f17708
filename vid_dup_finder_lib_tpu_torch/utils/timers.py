"""Phase timing (counterpart of ``vid_dup_finder_lib_tpu/utils/timers.py``,
without its profiler hook).

Replaces the reference's compile-time ``print_timings`` feature
(``vid_dup_finder_app/Cargo.toml:30``, timing prints across app_fns.rs) with
a runtime switch: set ``VDF_PRINT_TIMINGS=1`` for phase wall-clock prints.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time


def timings_enabled() -> bool:
    return os.environ.get("VDF_PRINT_TIMINGS", "") not in ("", "0")


@contextlib.contextmanager
def phase_timer(name: str):
    start = time.time()
    try:
        yield
    finally:
        if timings_enabled():
            print(
                f"{name} time: {time.time() - start}",
                file=sys.stdout,
            )

