"""The port's device preprocessing against the host golden path and the JAX
package's device versions.

* ``resize_frames_device``: cubes equal to ``golden.crop_resize_golden``
  and to the JAX ``resize_frames_device`` exactly, at odd sizes, with
  crops, in sub-batches, whatever float32 matmul precision the caller set.
* ``cropdetect_letterbox_device``: crops equal to the host
  ``cropdetect_letterbox`` and to the JAX device version, including a
  histogram tie (the last maximum is the mode) and the 108/120 edge of the
  90% test.
* ``hash_raw_frames_device`` and ``hash_videos(device_preproc=True)``:
  hashes within 2 bits of the JAX package's, cubes equal to the golden
  model's, groups equal to the host-preprocessing run.

Inputs are seeded NumPy; the port runs on CPU tensors.
"""

import os

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu_torch as tvdf
from tests.fixtures import make_fixture_videos
from vid_dup_finder_lib_tpu import crop as jax_crop
from vid_dup_finder_lib_tpu import definitions as jax_definitions
from vid_dup_finder_lib_tpu.models import builder as jax_builder
from vid_dup_finder_lib_tpu.models.pipeline import hash_raw_frames_device as jax_hash_raw
from vid_dup_finder_lib_tpu.models.pipeline import hash_videos as jax_hash_videos
from vid_dup_finder_lib_tpu.ops.golden import crop_resize_golden, hash_bits_golden
from vid_dup_finder_lib_tpu.ops.letterbox import cropdetect_letterbox
from vid_dup_finder_lib_tpu.ops.letterbox_device import (
    cropdetect_letterbox_device as jax_letterbox,
)
from vid_dup_finder_lib_tpu.ops.resize_device import resize_frames_device as jax_resize
from vid_dup_finder_lib_tpu_torch.crop import Crop
from vid_dup_finder_lib_tpu_torch.definitions import Cropdetect
from vid_dup_finder_lib_tpu_torch.models import pipeline
from vid_dup_finder_lib_tpu_torch.models.builder import CreationOptions
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk
from vid_dup_finder_lib_tpu_torch.ops import resize_device as rd
from vid_dup_finder_lib_tpu_torch.ops.letterbox import cropdetect_letterbox as port_letterbox_host
from vid_dup_finder_lib_tpu_torch.ops.letterbox_device import cropdetect_letterbox_device

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


def _jax_crop(c):
    """The JAX package's Crop for a crop of either package (or None)."""
    return None if c is None else jax_crop.Crop(c.orig_res, c.left, c.right, c.top, c.bottom)


def _edges(crops):
    return [(c.orig_res, c.left, c.right, c.top, c.bottom) for c in crops]


def _golden_cubes(frames, crops):
    """The JAX package's golden crop-and-resize of each video."""
    return np.stack([
        np.stack([crop_resize_golden(f, _jax_crop(c)) for f in video])
        for video, c in zip(frames, crops)
    ])


RESIZE_CASES = {
    "120x160": ((120, 160), None),
    "123x217": ((123, 217), None),
    "100x100_crop": ((100, 100), Crop.from_edge_offsets((100, 100), 7, 11, 3, 5)),
    "9x13_upscale": ((9, 13), None),
    "17x1000_crop": ((17, 1000), Crop.from_edge_offsets((1000, 17), 100, 3, 2, 0)),
    "270x480_crop": ((270, 480), Crop.from_edge_offsets((480, 270), 0, 0, 34, 34)),
}


@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_bit_exact(case):
    (h, w), crop = RESIZE_CASES[case]
    frames = np.random.default_rng(22).integers(0, 256, (3, 16, h, w), dtype=np.uint8)
    got = rd.resize_frames_device(torch.from_numpy(frames), crop)
    assert got.dtype == torch.uint8 and got.shape == (3, 16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), _golden_cubes(frames, [crop] * 3))
    np.testing.assert_array_equal(got.numpy(), jax_resize(frames, _jax_crop(crop)))


def test_resize_sub_batches_and_caller_precision(monkeypatch):
    """Sub-batches of one video give the same cubes, and a caller's
    reduced float32 matmul precision neither leaks in nor is lost."""
    frames = np.random.default_rng(23).integers(0, 256, (5, 16, 61, 83), dtype=np.uint8)
    want = _golden_cubes(frames, [None] * 5)
    monkeypatch.setattr(rd, "SUB_BATCH_BYTES", 1)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = rd.resize_frames_device(torch.from_numpy(frames))
        assert torch.get_float32_matmul_precision() == "medium"
        cubes = torch.from_numpy(want)
        hk.hash_cubes_plain(cubes)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(saved)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_fp32_guard_restores_on_error():
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError):
            with hk.full_fp32_matmul():
                assert torch.get_float32_matmul_precision() == "highest"
                raise RuntimeError("inside")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)


def test_resize_rejects_bad_frames():
    with pytest.raises(ValueError, match="uint8"):
        rd.resize_frames_device(torch.zeros((1, 16, 8, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        rd.resize_frames_device(torch.zeros((1, 8, 8, 8), dtype=torch.uint8))


def _tie_strip(rng, length):
    """A strip whose two most frequent values tie (0 and 40, 10 each) and
    whose other pixels all lie within 16 of the larger: a letterbox strip
    only if the last maximum is the mode."""
    spread = [v for v in range(25, 57) if v != 40]
    vals = [0] * 10 + [40] * 10 + [spread[k % len(spread)] for k in range(length - 20)]
    return rng.permutation(np.array(vals, dtype=np.uint8))


def _edge_strip(rng, length, matching):
    """``matching`` pixels of value 0 and the rest 200."""
    return rng.permutation(
        np.array([0] * matching + [200] * (length - matching), dtype=np.uint8)
    )


def _letterbox_frames():
    rng = np.random.default_rng(0)
    B, T, H, W = 9, 16, 48, 120
    frames = rng.integers(0, 256, (B, T, H, W), dtype=np.uint8)
    frames[1, :, :6] = 0  # black bars top and bottom
    frames[1, :, -6:] = 0
    frames[2, :, :, :10] = rng.integers(100, 104, (T, H, 10))  # grey pillarbox
    frames[2, :, :, -10:] = 102
    frames[3] = 77  # constant: degenerate, no crop
    frames[4, :, :3] = 0  # top only
    for t in range(T):
        for r in range(5):
            frames[5, t, r] = _tie_strip(rng, W)
            frames[6, t, r] = _edge_strip(rng, W, 108)  # 108/120: not > 0.9
            frames[7, t, r] = _edge_strip(rng, W, 109)
    frames[8, 8:, :, -7:] = 255  # a bar in the second sampled frame only
    frames[8, :8, :, -4:] = 255
    return frames


def test_letterbox_matches_host_and_jax():
    frames = _letterbox_frames()
    got = cropdetect_letterbox_device(torch.from_numpy(frames))
    assert all(type(c) is Crop for c in got)
    assert got == [port_letterbox_host(list(v)) for v in frames]
    assert _edges(got) == _edges(cropdetect_letterbox(list(v)) for v in frames)
    assert _edges(got) == _edges(jax_letterbox(frames))
    tops = [c.top for c in got]
    assert tops[5] == 5, "the histogram tie must resolve to the last maximum"
    assert tops[6] == 0 and tops[7] == 5, "108/120 is not above 0.9; 109/120 is"
    assert got[8].right == 4  # the union keeps the smaller bar
    assert len({c for c in got}) >= 5


def test_letterbox_rejects_bad_frames():
    with pytest.raises(ValueError, match="uint8"):
        cropdetect_letterbox_device(torch.zeros((1, 16, 8), dtype=torch.uint8))


def _raw_batch():
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (5, 16, 60, 80), dtype=np.uint8)
    frames[1, :, :8] = 0
    frames[1, :, -8:] = 0
    frames[2, :, :, :12] = 5
    frames[4, :, :, -9:] = 0
    return frames


def test_hash_raw_frames_device_matches_golden_and_jax():
    frames = _raw_batch()
    words = pipeline.hash_raw_frames_device(frames, device="cpu")
    assert words.dtype == torch.int32 and words.shape == (5, 32)
    got = words.numpy().view(np.uint32)
    crops = [cropdetect_letterbox(list(v)) for v in frames]
    cubes = _golden_cubes(frames, crops)
    np.testing.assert_array_equal(
        got, hk.hash_cubes(torch.from_numpy(cubes)).numpy().view(np.uint32)
    )
    jax_words = jax_hash_raw(frames)
    for b in range(len(frames)):
        h = tvdf.VideoHash.from_packed_u32(got[b])
        assert int((h.hash_bits() != hash_bits_golden(cubes[b])).sum()) <= 2
        assert int(np.bitwise_count(got[b] ^ jax_words[b]).sum()) <= 2


def test_hash_raw_frames_device_crops_and_no_letterbox():
    frames = _raw_batch()
    h, w = frames.shape[2:]
    crops = [Crop.from_edge_offsets((w, h), k, 0, 0, k) for k in range(5)]
    got = pipeline.hash_raw_frames_device(frames, crops=crops, device="cpu")
    want = hk.hash_cubes(torch.from_numpy(_golden_cubes(frames, crops)))
    assert torch.equal(got, want)
    none = pipeline.hash_raw_frames_device(torch.from_numpy(frames), letterbox=False)
    full = [Crop.from_edge_offsets((w, h), 0, 0, 0, 0)] * 5
    assert torch.equal(none, hk.hash_cubes(torch.from_numpy(_golden_cubes(frames, full))))
    with pytest.raises(ValueError, match="crops"):
        pipeline.hash_raw_frames_device(frames, crops=crops[:2], device="cpu")


@pytest.fixture(scope="module")
def videos():
    return make_fixture_videos(DATA_DIR)


@pytest.mark.parametrize("cropdetect", [Cropdetect.LETTERBOX, Cropdetect.MOTION, Cropdetect.NONE])
def test_device_preproc_pipeline_parity(videos, cropdetect):
    opts = CreationOptions(cropdetect=cropdetect)
    jax_opts = jax_builder.CreationOptions(
        cropdetect=jax_definitions.Cropdetect(cropdetect.value)
    )
    dev = pipeline.hash_videos(videos, opts, device="cpu", device_preproc=True)
    host = pipeline.hash_videos(videos, opts, device="cpu", device_preproc=False)
    jax_dev = jax_hash_videos(videos, options=jax_opts, device_preproc=True)
    assert set(dev) == set(host) == set(jax_dev) == set(videos)
    for v in videos:
        assert isinstance(dev[v], tvdf.VideoHash), dev[v]
        assert dev[v].duration == host[v].duration == jax_dev[v].duration
        assert dev[v].hamming_distance(host[v]) <= 2, v
        assert dev[v].hamming_distance(jax_dev[v]) <= 2, v
    groups = tvdf.search(list(dev.values()), device="cpu")
    assert groups == tvdf.search(list(host.values()), device="cpu")
    if cropdetect is Cropdetect.LETTERBOX:
        assert len(groups) == 2


def test_device_preproc_flushes_by_bytes_and_reads_env(videos, monkeypatch):
    calls = []
    real = pipeline.hash_raw_frames_device

    def spy(frames, **kw):
        calls.append(frames.shape[0])
        return real(frames, **kw)

    monkeypatch.setattr(pipeline, "hash_raw_frames_device", spy)
    monkeypatch.setenv("VDF_DEVICE_PREPROC", "1")
    one_video = 16 * 120 * 160  # bytes of one fixture's raw frames
    monkeypatch.setenv("VDF_PREPROC_BATCH_BYTES", str(2 * one_video))
    out = pipeline.hash_videos(videos, device="cpu")
    assert calls == [2, 2, 2]
    assert all(isinstance(h, tvdf.VideoHash) for h in out.values())
    monkeypatch.setenv("VDF_DEVICE_PREPROC", "0")
    calls.clear()
    pipeline.hash_videos(videos[:2], device="cpu")
    assert calls == []


def test_device_preproc_decode_errors_are_values(tmp_path):
    bogus = tmp_path / "not_a_video.mp4"
    bogus.write_bytes(b"\x00" * 64)
    out = pipeline.hash_videos([str(bogus)], device="cpu", device_preproc=True)
    assert isinstance(out[str(bogus)], tvdf.VdfError)
