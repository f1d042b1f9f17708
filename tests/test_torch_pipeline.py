"""The port's batch pipeline (``models.pipeline.hash_videos``) against the
JAX package's: the same clips decode through the same host code, then hash
on each package's device path.  Hashes may differ in fp32 sign flips
(<= 2 bits each); durations and groups must be equal.
"""

import os

import numpy as np
import pytest

import vid_dup_finder_lib_tpu_torch as tvdf
from tests.fixtures import make_fixture_videos
from vid_dup_finder_lib_tpu.models.pipeline import hash_videos as jax_hash_videos
from vid_dup_finder_lib_tpu_torch.models import pipeline

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def videos():
    return make_fixture_videos(DATA_DIR)


@pytest.fixture(scope="module")
def port_hashes(videos):
    return pipeline.hash_videos(videos, batch_size=4, device="cpu")


def test_hashes_match_jax_pipeline(videos, port_hashes):
    ref = jax_hash_videos(videos)
    assert set(port_hashes) == set(ref) == set(videos)
    for v in videos:
        ours, theirs = port_hashes[v], ref[v]
        assert isinstance(ours, tvdf.VideoHash), ours
        assert ours.src_path == v
        assert ours.duration == theirs.duration
        d = int(np.bitwise_count(ours.packed_u32() ^ theirs.packed_u32()).sum())
        assert d <= 2, (v, d)


def test_two_groups_of_three(port_hashes):
    groups = tvdf.search(list(port_hashes.values()), backend="device", device="cpu")
    names = sorted(sorted(os.path.basename(p)[:3] for p in g.contained_paths())
                   for g in groups)
    assert names == [["cat"] * 3, ["dog"] * 3]


def test_batches_reach_the_hash_contiguous(videos, monkeypatch):
    """The kernel takes only contiguous tensors; prepared cubes are
    transposed views, so the pipeline must hand over a packed copy."""
    seen = []
    real = pipeline.hash_cubes

    def spy(cubes):
        seen.append((tuple(cubes.shape), cubes.is_contiguous()))
        return real(cubes)

    monkeypatch.setattr(pipeline, "hash_cubes", spy)
    progress = []
    out = pipeline.hash_videos(
        videos[:3], batch_size=2, device="cpu",
        progress=lambda done, total: progress.append((done, total)),
    )
    assert seen == [((2, 16, 16, 16), True), ((1, 16, 16, 16), True)]
    assert progress == [(1, 3), (2, 3), (3, 3)]
    assert all(isinstance(h, tvdf.VideoHash) for h in out.values())


def test_decode_errors_are_values(tmp_path):
    bogus = tmp_path / "not_a_video.mp4"
    bogus.write_bytes(b"\x00" * 64)
    out = pipeline.hash_videos([str(bogus)], device="cpu")
    assert isinstance(out[str(bogus)], tvdf.VdfError)
