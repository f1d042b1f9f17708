"""Frame-extraction visualization utilities (counterpart of
``vid_dup_finder_lib_tpu/debug_util.py``).

Equivalent of the reference's ``debug_util`` module
(``vid_dup_finder_lib/src/lib.rs:147+``): dump the frames the hasher
actually consumes — raw decoded frames, the detected crop, and the final
16x16 inputs — so hash differences can be inspected visually.
"""

from __future__ import annotations

import os

import numpy as np

from .models.builder import (
    CreationOptions,
    build_frame_reader,
    detect_crop,
    iterate_video_frames,
)
from .ops.golden import crop_resize_golden


def dump_hash_frames(
    src_path: str,
    out_dir: str,
    options: CreationOptions = CreationOptions(),
) -> dict:
    """Write raw / cropped / 16x16 frame images for one video.

    Returns a summary dict (frame count, detected crop, output paths).
    """
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    cfg = build_frame_reader(src_path, options)
    frames = iterate_video_frames(cfg)
    # detect once and apply directly (crop_video_frames would re-run the
    # detection — for Cropdetect.MOTION that is the expensive host step)
    crop = detect_crop(frames, options.cropdetect)
    if crop is None:
        cropped = frames
    else:
        x, y, w, h = crop.as_view_args()
        cropped = [f[y : y + h, x : x + w] for f in frames]

    written = []
    for i, (raw, c) in enumerate(zip(frames, cropped)):
        p_raw = os.path.join(out_dir, f"{i:02}_raw.png")
        p_crop = os.path.join(out_dir, f"{i:02}_cropped.png")
        p_small = os.path.join(out_dir, f"{i:02}_16x16.png")
        Image.fromarray(raw).save(p_raw)
        Image.fromarray(c).save(p_crop)
        small = crop_resize_golden(c)
        Image.fromarray(
            np.kron(small, np.ones((8, 8), dtype=np.uint8))
        ).save(p_small)  # 8x nearest-neighbor upscale for visibility
        written += [p_raw, p_crop, p_small]

    return {
        "num_frames": len(frames),
        "crop": None if crop is None else crop.as_view_args(),
        "cropdetect": options.cropdetect.value,
        "files": written,
    }


def hash_bit_image(hash_obj, out_path: str) -> None:
    """Render the 1000 hash bits as a 10-frame strip of 10x10 tiles."""
    from PIL import Image

    bits = hash_obj.hash_bits().reshape(10, 10, 10)
    strip = np.concatenate(list(bits.astype(np.uint8) * 255), axis=1)
    Image.fromarray(np.kron(strip, np.ones((8, 8), np.uint8))).save(out_path)
