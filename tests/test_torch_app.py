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


# -- the duplicate resolver: TTY carousel and web app --------------------------


def _group_files(root, spec):
    """Files ``{dir: [names]}`` under ``root`` with distinct contents; one
    list of paths per directory."""
    out = []
    for d, names in spec.items():
        (root / d).mkdir(parents=True)
        paths = []
        for i, name in enumerate(names):
            (root / d / name).write_bytes(b"x" + bytes([i]))
            paths.append(str(root / d / name))
        out.append(paths)
    return out


_TWO_GROUPS = {"a": ["v0.mp4", "v1.mp4", "v2.mp4"], "b": ["w0.mp4", "w1.mp4"]}


def _tui(package, groups, script, **kw):
    """Run one package's TTY resolver over path lists on scripted input;
    (the resolver, what it printed)."""
    import importlib

    resolver = importlib.import_module(f"{package}.app.resolver_tui")
    match_group = importlib.import_module(f"{package}.match_group")
    out = io.StringIO()
    tui = resolver.run_resolver(
        [match_group.MatchGroup.new(g) for g in groups],
        inp=io.StringIO(script), out=out, thumbs=False, **kw)
    return tui, out.getvalue()


PACKAGES = ("vid_dup_finder_lib_tpu", "vid_dup_finder_lib_tpu_torch")


@pytest.mark.parametrize("script", ["", "n\nq\n"])
def test_resolver_tui_without_groups(script):
    from vid_dup_finder_lib_tpu.app.resolver_tui import ResolverTui as JaxTui
    from vid_dup_finder_lib_tpu_torch.app.resolver_tui import ResolverTui

    texts = []
    for cls in (JaxTui, ResolverTui):
        out = io.StringIO()
        assert cls([], inp=io.StringIO(script), out=out).run() is None
        texts.append(out.getvalue())
    assert texts[1] == texts[0] == "no duplicate groups to resolve\n"


def test_resolver_tui_navigation_wraps_around(tmp_path):
    """Two groups: previous from the first lands on the last, next from the
    last on the first, a jump past the end is refused; both packages print
    the same on the same files."""
    groups = _group_files(tmp_path, _TWO_GROUPS)
    script = "p\nn\nn\n\ng2\ng9\nbanana\n7\nq\n"
    (_, want), (tui, got) = (_tui(p, groups, script) for p in PACKAGES)
    assert got == want
    shown = [line.split()[2] for line in got.splitlines() if line.startswith("=== group")]
    assert shown == ["1/2", "2/2", "1/2", "2/2", "1/2", "2/2", "2/2", "2/2", "2/2"]
    assert "error: group 9 out of range" in got and got.count("error:") == 3
    assert len(tui.thunks) == 2 and all(os.path.exists(p) for g in groups for p in g)


def test_resolver_tui_resolves_like_the_jax_package(tmp_path):
    """Keep, rename, untrash and quit, each package on its own copy of the
    files: the same transcript and the same files left."""
    script = "p\n0\nn\n1 as 2\nu0\nq\n"
    texts, trees = [], []
    for k, package in enumerate(PACKAGES):
        root = tmp_path / f"run{k}"
        groups = _group_files(root, _TWO_GROUPS)
        _, text = _tui(package, groups, script, trash_dir=str(root / "trash"))
        texts.append(text.replace(str(root), "ROOT"))
        trees.append(sorted(
            os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs))
    assert texts[1] == texts[0] and trees[1] == trees[0]
    assert "[trashed]" in texts[1] and "untrashed" in texts[1]
    assert "b/w0.mp4" in trees[1] and "b/w1.mp4" not in trees[1]  # 'p' wrapped to group 2


def test_resolver_web_state_equals_the_jax_package(tmp_path):
    import importlib

    groups = _group_files(tmp_path, _TWO_GROUPS)
    apps = []
    for package in PACKAGES:
        web = importlib.import_module(f"{package}.app.resolver_web")
        thunk = importlib.import_module(f"{package}.app.resolution_thunk").ResolutionThunk
        match_group = importlib.import_module(f"{package}.match_group").MatchGroup
        apps.append(web.ResolverWebApp([thunk.from_matchgroup(match_group.new(g)) for g in groups]))
        assert web.ResolverWebApp([]).state(3, False) == {
            "group": 0, "n_groups": 0, "max_distance": None, "entries": [], "log": []}
    theirs, ours = apps
    for gi in (0, 1, 99, -5):
        st = ours.state(gi, False)
        assert st == theirs.state(gi, False)
        assert st["group"] == max(0, min(gi, 1)) and st["n_groups"] == 2
        assert [e["path"] for e in st["entries"]] == sorted(groups[st["group"]])
    ok, actions = ours.resolve(0, "9")
    assert not ok and ours.state(0, False)["log"] == [f"group 1: error: {actions[0]}"]


def test_resolver_web_serves_state(tmp_path):
    import urllib.request

    from vid_dup_finder_lib_tpu_torch.app.resolver_web import start_resolver_web
    from vid_dup_finder_lib_tpu_torch.match_group import MatchGroup

    groups = _group_files(tmp_path, _TWO_GROUPS)
    server, app = start_resolver_web([MatchGroup.new(g) for g in groups], port=0)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api/state?g=1"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200 and json.loads(r.read()) == app.state(1, False)
    finally:
        server.shutdown()
        server.server_close()


def test_cli_gui_runs_the_resolver(vids, tmp_path, monkeypatch):
    """``--gui-slint`` reaches the TTY resolver over the fixture groups with
    input from stdin; the port prints what the JAX CLI prints."""
    import sys

    args = ["--gui-slint", "--gui-trash-path", str(tmp_path / "trash")]
    monkeypatch.setattr(sys, "stdin", io.StringIO("n\nn\np\nq\n"))
    rc, want = _run(jax_run_app, _json_args(DATA_DIR, tmp_path / "jax.json", *args))
    assert rc == 0
    monkeypatch.setattr(sys, "stdin", io.StringIO("n\nn\np\nq\n"))
    rc, got = _run(run_app, _json_args(DATA_DIR, tmp_path / "port.json", *args), device="cpu")
    assert rc == 0 and got == want
    assert got.count("=== group") == 4 and "group 2/2" in got
    assert not (tmp_path / "trash").exists() or not os.listdir(tmp_path / "trash")
