"""Batched letterbox detection on the device.

Counterpart of ``vid_dup_finder_lib_tpu/ops/letterbox_device.py``, with
the semantics of the host ``ops/letterbox.cropdetect_letterbox``
(``video_frames_gray.rs:38-163,201-210``).  Per sampled frame and side:

    256-bin histogram per strip (row or column)  ->  modal value (the last
    maximum, as Rust's ``max_by_key``)  ->  pixels within ``TOL`` of it
    ->  more than 90% of the strip?  ->  take-while from the edge  ->
    per-frame crop (no crop when nothing would remain)  ->  union over the
    sampled frames (the smallest offset of each edge).

The JAX version histograms by a one-hot compare that XLA fuses; eagerly
that would materialise ``strips x length x 256`` booleans (gigabytes for
a 1080p batch), so here one ``bincount`` over ``strip * 256 + value``
counts every strip of a side at once.  ``TOL`` and the integer form of the
90% test (``_PROP_NUM / _PROP_DEN``, exact at ratios such as 108/120) are
the JAX module's constants, derived the same way.
"""

from __future__ import annotations

from fractions import Fraction

import torch

from ..crop import Crop
from .letterbox import MIN_PROPORTION

TOL = 16  # cropdetect_letterbox uses AnyColour(16)
# exact integer form of `matching / strip_len > MIN_PROPORTION`: float32
# division disagrees with the host's float64 at ratios such as 108/120
_PROP_NUM = Fraction(MIN_PROPORTION).limit_denominator(1000).numerator
_PROP_DEN = Fraction(MIN_PROPORTION).limit_denominator(1000).denominator


def strip_histograms(strips: torch.Tensor) -> torch.Tensor:
    """uint8[..., S, L] strips -> int64[..., S, 256] value counts."""
    *lead, s, length = strips.shape
    n = strips.numel() // length if length else 0
    keys = strips.reshape(n, length).to(torch.int64)
    keys += torch.arange(n, device=strips.device).mul_(256)[:, None]
    hist = torch.bincount(keys.reshape(-1), minlength=n * 256)
    return hist.view(*lead, s, 256)


def strip_flags(strips: torch.Tensor) -> torch.Tensor:
    """bool[..., S]: is each strip of uint8[..., S, L] letterbox-coloured
    (``AnyColour(TOL)``)?"""
    hist = strip_histograms(strips)
    # the last maximum: argmax returns the first, so search the values
    # from 255 down
    mode = 255 - torch.argmax(hist.flip(-1), dim=-1, keepdim=True)
    csum = torch.cumsum(hist, dim=-1)
    top = torch.gather(csum, -1, (mode + TOL).clamp_(max=255))
    lo = mode - TOL
    bot = torch.where(
        lo > 0, torch.gather(csum, -1, (lo - 1).clamp_(min=0)), 0
    )
    matching = (top - bot).squeeze(-1)
    return _PROP_DEN * matching > _PROP_NUM * strips.shape[-1]


def _take_while(flags: torch.Tensor) -> torch.Tensor:
    """Leading True count along the last axis."""
    return torch.cumprod(flags.to(torch.int32), dim=-1).sum(-1)


def letterbox_offsets(frames: torch.Tensor) -> torch.Tensor:
    """uint8[B, T, H, W] sampled frames -> int64[B, 4] edge offsets (left,
    right, top, bottom): per-frame crops with the degenerate-frame
    fallback, united over the frames."""
    _, _, h, w = frames.shape
    cols = strip_flags(frames.transpose(2, 3))  # [B, T, W]
    rows = strip_flags(frames)  # [B, T, H]
    edges = torch.stack(
        [_take_while(cols), _take_while(cols.flip(-1)),
         _take_while(rows), _take_while(rows.flip(-1))], dim=-1,
    )  # [B, T, 4]
    degenerate = (w - edges[..., 0] - edges[..., 1] < 1) | (
        h - edges[..., 2] - edges[..., 3] < 1
    )
    edges = edges.masked_fill(degenerate[..., None], 0)
    return edges.amin(dim=1)


def cropdetect_letterbox_device(frames: torch.Tensor) -> list[Crop]:
    """uint8[B, T, H, W] frames on a device -> one ``Crop`` per video,
    equal to ``cropdetect_letterbox(list(frames[b]))``: frames
    ``[::8][:8]`` are sampled, as the host does."""
    if frames.dtype != torch.uint8 or frames.ndim != 4:
        raise ValueError(
            f"frames must be uint8[B, T, H, W], got {frames.dtype}{list(frames.shape)}"
        )
    _, _, h, w = frames.shape
    offsets = letterbox_offsets(frames[:, ::8][:, :8]).cpu().tolist()
    return [Crop.from_edge_offsets((w, h), *o) for o in offsets]
