"""Thumbnail montages and group utilities.

Equivalent of ``MatchGroupExt`` (``…/app/match_group_ext.rs:36-277``):
render a labelled grid of frames per group (retrying a ladder of sampling
rates, with a red "Error" tile fallback), filter groups by a
FilenamePattern, and split a multi-reference group per reference.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

from ..cache.filename_pattern import FilenamePattern
from ..ingest.backend import FrameReadCfg
from ..match_group import MatchGroup, TooFewEntries

THUMB_HEIGHT = 150  # px (match_group_ext.rs:118)
NUM_THUMBS = 4
# sampling ladder: (num, den) fps fractions tried in order (:107-116)
FPS_LADDER = [(1, 5), (2, 1), (5, 1), (30, 1)]


def _video_thumbs(path: str) -> list[np.ndarray]:
    for fps in FPS_LADDER:
        try:
            cfg = FrameReadCfg(path, fps=fps)
            frames = []
            for f in cfg.spawn_rgb():
                frames.append(f)
                if len(frames) >= NUM_THUMBS:
                    break
            if len(frames) >= 1:
                return frames
        except Exception:
            continue
    raise RuntimeError(f"no frames decodable from {path}")


def _error_tile(label: str) -> Image.Image:
    img = Image.new("RGB", (THUMB_HEIGHT * 2, THUMB_HEIGHT), (200, 30, 30))
    d = ImageDraw.Draw(img)
    d.text((6, 6), "Error", fill=(255, 255, 255))
    d.text((6, 24), label[-40:], fill=(255, 255, 255))
    return img


def _row_for_video(path: str) -> Image.Image:
    try:
        frames = _video_thumbs(path)
        tiles = []
        for f in frames:
            img = Image.fromarray(f)
            w = max(1, int(img.width * THUMB_HEIGHT / img.height))
            tiles.append(img.resize((w, THUMB_HEIGHT)))
        row_w = sum(t.width for t in tiles)
        row = Image.new("RGB", (row_w, THUMB_HEIGHT), (0, 0, 0))
        x = 0
        for t in tiles:
            row.paste(t, (x, 0))
            x += t.width
    except Exception:
        row = _error_tile(path)
    # text label strip above the row
    label_h = 16
    out = Image.new("RGB", (row.width, THUMB_HEIGHT + label_h), (20, 20, 20))
    d = ImageDraw.Draw(out)
    d.text((4, 2), path, fill=(230, 230, 230))
    out.paste(row, (0, label_h))
    return out


def group_to_image(group: MatchGroup) -> Image.Image:
    """One labelled frame-row per video, stacked (match_group_ext.rs:107-277)."""
    rows = [_row_for_video(p) for p in group.contained_paths()]
    w = max(r.width for r in rows)
    h = sum(r.height for r in rows)
    out = Image.new("RGB", (w, h), (0, 0, 0))
    y = 0
    for r in rows:
        out.paste(r, (0, y))
        y += r.height
    return out


def filter_group(
    group: MatchGroup, pattern: FilenamePattern
) -> MatchGroup | None:
    """Keep only paths accepted by the pattern (match_group_ext.rs:36-67)."""
    dups = [p for p in group.duplicates if pattern.includes_path(p)]
    ref = group.reference
    if ref is not None and not pattern.includes_path(ref):
        ref = None
    try:
        if ref is not None:
            return MatchGroup.new_with_reference(ref, dups)
        return MatchGroup.new(dups)
    except TooFewEntries:
        return None


def extract_reference(group: MatchGroup, references: list[str]):
    """Split a group into per-reference groups (match_group_ext.rs:69-103)."""
    out = []
    refs_in_group = [p for p in group.contained_paths() if p in references]
    others = [p for p in group.contained_paths() if p not in references]
    for r in refs_in_group:
        try:
            out.append(MatchGroup.new_with_reference(r, others))
        except TooFewEntries:
            pass
    return out
