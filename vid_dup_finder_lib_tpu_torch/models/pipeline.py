"""Batched streaming hash pipeline (counterpart of
``vid_dup_finder_lib_tpu/models/pipeline.py``'s ``hash_videos`` and
``hash_raw_frames_device``).

Host preprocessing (the default): a host thread pool decodes, crops and
resizes videos into 16x16x16 cubes (:func:`safe_prepare`);
each batch of cubes goes to the device from pinned memory without blocking
and through :func:`..ops.hash_kernel.hash_cubes`.  Kernel launches are
asynchronous, so batch k hashes while batch k+1 decodes; the packed hashes
(128 B per video) come back once the pool has drained.

Device preprocessing (``device_preproc=True``, default from
``VDF_DEVICE_PREPROC``): the host only decodes 16 raw frames per video;
batches of one resolution go to the device once from pinned memory, and
letterbox detection (:mod:`..ops.letterbox_device`), the per-crop resize
(:mod:`..ops.resize_device`) and the hash kernel run there
(:func:`hash_raw_frames_device`).  No pixel comes back to the host.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np
import torch

from ..crop import Crop
from ..definitions import Cropdetect
from ..errors import VdfError, VidProc
from ..ops.hash_kernel import hash_cubes
from ..ops.letterbox_device import cropdetect_letterbox_device
from ..ops.resize_device import resize_frames_device
from ..utils.device import resolve_device
from ..video_hash import VideoHash
from .builder import CreationOptions, prepare_frames, prepare_raw_frames

DEFAULT_BATCH = 256  # videos per host-preprocessed device batch
DEFAULT_PREPROC_BATCH_BYTES = 512 * 2**20  # raw frames per device batch


def safe_prepare(path: str, options: CreationOptions):
    """Decode and preprocess one video, mapping failures to cacheable
    error values (generic_cache_if.rs:22-44's contract): a VdfError passes
    through, anything a decode library throws becomes VidProc.  Returns
    (path, cube | None, duration, error | None); the pipeline and the
    cache share it, so the error-wrapping rules cannot drift."""
    try:
        cube, dur = prepare_frames(path, options)
        return (path, cube, dur, None)
    except VdfError as e:
        return (path, None, 0, e)
    except Exception as e:  # decode libraries can throw anything
        return (path, None, 0, VidProc(f"{e!r}"))


def _to_device(host: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A contiguous host array on ``dev``, from pinned memory on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t


def hash_raw_frames_device(
    frames: np.ndarray | torch.Tensor,
    letterbox: bool = True,
    crops: list[Crop] | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Preprocess and hash a batch of one resolution on ``device``:
    uint8[B, 16, H, W] raw frames -> int32[B, 32] packed hashes (the words
    of ``VideoHash.packed_u32`` as int32 bit patterns), on the device.

    Host frames go to ``device`` once; a tensor is used where it lies
    (``device``, when given, must name that device).  Letterbox detection
    runs there unless ``crops`` (one per video, the host-detected crops of
    ``Cropdetect.MOTION`` / ``NONE``) are given, or ``letterbox`` is False
    (no crop).  Videos are grouped by crop, and each group resizes with its
    own weights."""
    if isinstance(frames, torch.Tensor):
        dev = frames.device if device is None else resolve_device(device)
        if frames.device != dev:
            raise ValueError(f"frames lie on {frames.device}, not on {dev}")
    else:
        dev = resolve_device(device)
        frames = _to_device(frames, dev)
    b, _, h, w = frames.shape
    if crops is not None:
        if len(crops) != b:
            raise ValueError(f"{len(crops)} crops for {b} videos")
    elif letterbox:
        crops = cropdetect_letterbox_device(frames)
    else:
        crops = [Crop.from_edge_offsets((w, h), 0, 0, 0, 0)] * b
    by_crop: dict[Crop, list[int]] = {}
    for i, c in enumerate(crops):
        by_crop.setdefault(c, []).append(i)
    if len(by_crop) == 1:
        cubes = resize_frames_device(frames, crops[0])
    else:
        cubes = torch.empty((b, 16, 16, 16), dtype=torch.uint8, device=dev)
        for crop, idxs in by_crop.items():
            idx = torch.tensor(idxs, device=dev)
            cubes[idx] = resize_frames_device(frames.index_select(0, idx), crop)
    return hash_cubes(cubes)


def hash_videos(
    paths: Iterable[str],
    options: CreationOptions = CreationOptions(),
    batch_size: int = DEFAULT_BATCH,
    decode_workers: int = 8,
    progress: Callable[[int, int], None] | None = None,
    device: torch.device | str | None = None,
    device_preproc: bool | None = None,
) -> dict[str, VideoHash | VdfError]:
    """Hash many videos on ``device``; returns {path: VideoHash | VdfError}.

    Decode errors become values (the cache stores them), not exceptions.
    ``device_preproc`` (default: the ``VDF_DEVICE_PREPROC`` environment
    variable, off when unset, empty or "0") moves letterbox detection and
    the resize onto the device too."""
    dev = resolve_device(device)
    if device_preproc is None:
        device_preproc = os.environ.get("VDF_DEVICE_PREPROC", "") not in ("", "0")
    if device_preproc:
        return _hash_videos_device_preproc(
            paths, options, batch_size, decode_workers, progress, dev
        )
    paths = [os.fspath(p) for p in paths]
    results: dict[str, VideoHash | VdfError] = {}

    def dispatch(batch):
        metas = [(p, dur) for (p, _, dur, _) in batch]
        # prepared cubes are transposed views; np.stack keeps their strides
        cubes = _to_device(np.stack([c for (_, c, _, _) in batch]), dev)
        return metas, hash_cubes(cubes)

    pending: list[tuple[list, torch.Tensor]] = []
    buf: list = []
    done = 0
    total = len(paths)
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        # pool.map yields in order while decoding ahead, so the decode of
        # batch k+1 overlaps the device hash of batch k
        for item in pool.map(lambda p: safe_prepare(p, options), paths):
            p, _, _, err = item
            done += 1
            if err is not None:
                results[p] = err
            else:
                buf.append(item)
                if len(buf) >= batch_size:
                    pending.append(dispatch(buf))
                    buf = []
            if progress:
                progress(done, total)
        if buf:
            pending.append(dispatch(buf))

    for metas, words in pending:
        rows = words.cpu().numpy().view(np.uint32)
        for (p, dur), row in zip(metas, rows):
            results[p] = VideoHash.from_packed_u32(row, p, dur)
    return results


def _prepare_raw(path: str, options: CreationOptions):
    """Decode 16 raw frames (and, unless LETTERBOX, detect the crop on the
    host); failures become cacheable error values, as in ``safe_prepare``.
    Returns (path, frames | None, crop | None, duration, error | None)."""
    try:
        frames, crop, dur = prepare_raw_frames(path, options)
        return (path, frames, crop, dur, None)
    except VdfError as e:
        return (path, None, None, 0, e)
    except Exception as e:  # decode libraries can throw anything
        return (path, None, None, 0, VidProc(f"{e!r}"))


def _hash_videos_device_preproc(
    paths: Iterable[str],
    options: CreationOptions,
    batch_size: int,
    decode_workers: int,
    progress: Callable[[int, int], None] | None,
    dev: torch.device,
) -> dict[str, VideoHash | VdfError]:
    """``hash_videos`` with device preprocessing: the host decodes raw
    frames only, grouped by resolution; a group is flushed through
    :func:`hash_raw_frames_device` at ``batch_size`` videos or at
    ``VDF_PREPROC_BATCH_BYTES`` (default 512 MiB) of frames, whichever
    comes first.  Letterbox crops are detected on the device; the crops of
    ``Cropdetect.MOTION`` / ``NONE`` on the host."""
    paths = [os.fspath(p) for p in paths]
    results: dict[str, VideoHash | VdfError] = {}
    host_crops = options.cropdetect is not Cropdetect.LETTERBOX
    max_group_bytes = int(
        os.environ.get("VDF_PREPROC_BATCH_BYTES", str(DEFAULT_PREPROC_BATCH_BYTES))
    )

    def flush(batch) -> None:
        frames = np.stack([f for (_, f, _, _, _) in batch])
        crops = [c for (_, _, c, _, _) in batch] if host_crops else None
        words = hash_raw_frames_device(frames, crops=crops, device=dev)
        for (p, _, _, dur, _), row in zip(batch, words.cpu().numpy().view(np.uint32)):
            results[p] = VideoHash.from_packed_u32(row, p, dur)

    groups: dict[tuple[int, int], list] = {}
    done = 0
    total = len(paths)
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        for item in pool.map(lambda p: _prepare_raw(p, options), paths):
            p, frames, _, _, err = item
            done += 1
            if err is not None:
                results[p] = err
            else:
                res = frames.shape[1:]
                group = groups.setdefault(res, [])
                group.append(item)
                if (
                    len(group) >= batch_size
                    or len(group) * frames.nbytes >= max_group_bytes
                ):
                    flush(groups.pop(res))
            if progress:
                progress(done, total)
    for batch in groups.values():
        flush(batch)
    return results
