"""Image compositing helpers for montage outputs (counterpart of
``vid_dup_finder_lib_tpu/ops/compositing.py``).

Equivalent of ``vid_dup_finder_common/src/compositing.rs:11-104``:
``grid_images_rgb`` (rows x cols grid), ``row_images`` (horizontal strip)
and ``stack_images`` (vertical strip), over u8 RGB numpy arrays.  Host-side
only — these feed thumbnail files, not the hash path.
"""

from __future__ import annotations

import numpy as np


def row_images(images: list[np.ndarray], pad: int = 0) -> np.ndarray:
    """Concatenate images left-to-right, bottom-padding to the max height."""
    assert images
    h = max(i.shape[0] for i in images)
    parts = []
    for idx, img in enumerate(images):
        canvas = np.zeros((h, img.shape[1], 3), dtype=np.uint8)
        canvas[: img.shape[0]] = img
        parts.append(canvas)
        if pad and idx != len(images) - 1:
            parts.append(np.zeros((h, pad, 3), dtype=np.uint8))
    return np.concatenate(parts, axis=1)


def stack_images(images: list[np.ndarray], pad: int = 0) -> np.ndarray:
    """Concatenate images top-to-bottom, right-padding to the max width."""
    assert images
    w = max(i.shape[1] for i in images)
    parts = []
    for idx, img in enumerate(images):
        canvas = np.zeros((img.shape[0], w, 3), dtype=np.uint8)
        canvas[:, : img.shape[1]] = img
        parts.append(canvas)
        if pad and idx != len(images) - 1:
            parts.append(np.zeros((pad, w, 3), dtype=np.uint8))
    return np.concatenate(parts, axis=0)


def grid_images_rgb(rows: list[list[np.ndarray]], pad: int = 0) -> np.ndarray:
    """A grid: each inner list becomes one row."""
    return stack_images([row_images(r, pad) for r in rows], pad)
