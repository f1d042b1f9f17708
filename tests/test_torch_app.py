"""The port's hash cache and CLI against the JAX package's.

``run_app`` runs in process on the CPU (``device="cpu"``) over the bundled
fixture videos: its JSON output must equal the JAX CLI's, plain and with
``--with-refs``; a cache written by one package is reused by the other
with nothing rehashed; and the port hashes through its own hash, never
through the JAX package's.
"""

import contextlib
import io
import json
import os
import shutil

import pytest
import torch

from tests.fixtures import make_fixture_videos
from vid_dup_finder_lib_tpu.app.app_fns import run_app as jax_run_app
from vid_dup_finder_lib_tpu.cache.hash_cache import (
    VideoHashFilesystemCache as JaxCache,
)
from vid_dup_finder_lib_tpu.definitions import Cropdetect as JaxCropdetect
from vid_dup_finder_lib_tpu.models.builder import CreationOptions as JaxCreationOptions
from vid_dup_finder_lib_tpu.ops import hash_kernel as jax_hash_kernel
from vid_dup_finder_lib_tpu_torch.app import app_fns
from vid_dup_finder_lib_tpu_torch.app.app_fns import run_app
from vid_dup_finder_lib_tpu_torch.cache import VideoHashFilesystemCache
from vid_dup_finder_lib_tpu_torch.definitions import Cropdetect
from vid_dup_finder_lib_tpu_torch.models import pipeline
from vid_dup_finder_lib_tpu_torch.models.builder import CreationOptions

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
OPTS = CreationOptions(cropdetect=Cropdetect.LETTERBOX)
JAX_OPTS = JaxCreationOptions(cropdetect=JaxCropdetect.LETTERBOX)


@pytest.fixture(scope="module")
def vids():
    return make_fixture_videos(DATA_DIR)


def _run(fn, args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(args, **kw)
    return rc, out.getvalue()


def _json_args(files, cache, *extra):
    return ["--files", str(files), "--cache-file", str(cache),
            "--cropdetect", "letterbox", "--output-format", "json", *extra]


def _refuse_jax_hash(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the port reached the JAX package's hash")

    for name in ("hash_cubes_device", "hash_cubes_device_async"):
        monkeypatch.setattr(jax_hash_kernel, name, refuse)


def test_cli_json_equals_jax_cli(vids, tmp_path, monkeypatch):
    rc, want = _run(jax_run_app, _json_args(DATA_DIR, tmp_path / "jax.json"))
    assert rc == 0
    _refuse_jax_hash(monkeypatch)
    rc, got = _run(run_app, _json_args(DATA_DIR, tmp_path / "port.json"), device="cpu")
    assert rc == 0
    assert got == want
    groups = json.loads(got)
    assert sorted(sorted(os.path.basename(p)[:3] for p in g["duplicates"]) for g in groups) == [
        ["cat"] * 3, ["dog"] * 3
    ]


def test_cli_with_refs_equals_jax_cli(vids, tmp_path):
    refs, cands = tmp_path / "refs", tmp_path / "cands"
    refs.mkdir()
    cands.mkdir()
    shutil.copy(vids[0], refs / "cat.1.mp4")
    for v in vids[1:]:
        shutil.copy(v, cands / os.path.basename(v))
    args = ["--with-refs", str(refs)]
    rc, want = _run(jax_run_app, _json_args(cands, tmp_path / "jax.json", *args))
    assert rc == 0
    rc, got = _run(run_app, _json_args(cands, tmp_path / "port.json", *args), device="cpu")
    assert rc == 0 and got == want
    groups = json.loads(got)
    assert len(groups) == 1 and groups[0]["reference"].endswith("refs/cat.1.mp4")


def test_cli_reuses_a_jax_written_cache(vids, tmp_path, monkeypatch):
    cache = tmp_path / "cache.json"
    rc, want = _run(jax_run_app, _json_args(DATA_DIR, cache))
    assert rc == 0
    rehashed = []
    real = app_fns.update_hash_cache

    def spy(cfg, c):
        rehashed.append(real(cfg, c))
        return rehashed[-1]

    monkeypatch.setattr(app_fns, "update_hash_cache", spy)
    monkeypatch.setattr(pipeline, "hash_cubes", lambda *a: pytest.fail("rehashed"))
    rc, got = _run(run_app, _json_args(DATA_DIR, cache), device="cpu")
    assert rc == 0 and got == want and rehashed == [0]


def test_port_cache_is_read_by_the_jax_cache(vids, tmp_path):
    path = tmp_path / "cache.json"
    cache = VideoHashFilesystemCache(path, creation_options=OPTS, device="cpu")
    assert cache.update_using_fs(vids) == len(vids)
    assert cache.update_using_fs(vids) == 0
    cache.save()
    theirs = JaxCache(path, creation_options=JAX_OPTS)
    assert theirs.update_using_fs(vids) == 0
    ours_h = cache.fetch_hashes(vids)
    assert [h.src_path for h in theirs.fetch_hashes(vids)] == [h.src_path for h in ours_h]
    jax_fresh = JaxCache(tmp_path / "jax.json", creation_options=JAX_OPTS)
    jax_fresh.update_using_fs(vids)
    for mine, ref in zip(ours_h, jax_fresh.fetch_hashes(vids)):
        assert mine.duration == ref.duration
        assert mine.hamming_distance(ref) <= 2


def test_cache_load_one_and_device_preproc(vids, tmp_path, monkeypatch):
    _refuse_jax_hash(monkeypatch)
    cache = VideoHashFilesystemCache(tmp_path / "c.json", creation_options=OPTS, device="cpu")
    assert cache.device == torch.device("cpu")
    h = cache.fetch_update(vids[0])
    ref = JaxCache(tmp_path / "j.json", creation_options=JAX_OPTS)
    monkeypatch.undo()
    assert h.hamming_distance(ref.fetch_update(vids[0])) <= 2
    _refuse_jax_hash(monkeypatch)
    other = VideoHashFilesystemCache(tmp_path / "d.json", creation_options=OPTS, device="cpu")
    progress = []
    n = other.update_using_fs(vids, device_preproc=True, progress=lambda *a: progress.append(a))
    assert n == len(vids) and progress == [(len(vids), len(vids))]
    for v in vids:
        assert other.fetch(v).hamming_distance(cache.fetch_update(v)) <= 2


def test_cache_stores_and_reloads_errors(tmp_path):
    bogus = tmp_path / "bogus.mp4"
    bogus.write_bytes(b"\x00" * 64)
    cache = VideoHashFilesystemCache(tmp_path / "c.json", creation_options=OPTS, device="cpu")
    assert cache.update_using_fs([str(bogus)]) == 1
    assert cache.error_paths() == [str(bogus)]
    assert cache.update_using_fs([str(bogus)]) == 0
    assert cache.update_using_fs([str(bogus)], reload_errors=True) == 1


def test_cli_device_is_resolved_first(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for CUDA-less hosts")
    with pytest.raises(RuntimeError, match="is_available"):
        run_app(_json_args(DATA_DIR, tmp_path / "c.json"), device="cuda")
    assert not (tmp_path / "c.json").exists()
    rc, _ = _run(run_app, ["--help"], device="cpu")
    assert rc == 0


def test_cli_update_cache_only_and_unique_output(vids, tmp_path):
    cache = tmp_path / "c.json"
    rc, out = _run(run_app, _json_args(DATA_DIR, cache, "--update-cache-only"), device="cpu")
    assert rc == 0 and out == ""
    hashes = VideoHashFilesystemCache(cache, creation_options=OPTS, device="cpu")
    assert len(hashes) == len(vids)
    rc, out = _run(
        run_app,
        ["--files", DATA_DIR, "--cache-file", str(cache), "--cropdetect", "letterbox",
         "--no-update-cache", "--output", "unique"],
        device="cpu",
    )
    assert rc == 0 and out.strip() == ""  # every fixture video is a duplicate
