"""The port stands apart from JAX, and never swaps the CPU in for a device.

* Importing and running the port works with ``jax`` made unimportable, and
  with the JAX package made unimportable as well; no source of the port,
  nor ``chip_smoke.py``, imports either.
* The port's copies of the JAX package's host code (sort key, greedy
  replay, duration windows) behave as the originals; two faults of the
  originals are repaired in the copies.
* ``chip_smoke.py`` fails, and prints no result, on a host without CUDA,
  and also when it is alone in a directory.
* A CPU tensor goes to a kernel's plain version without touching the
  kernel library; asking for ``cuda`` without CUDA raises.
* The CLI and the library search run with ``jax`` unimportable; the CLI
  takes its device from ``VDF_TORCH_DEVICE`` (default ``cuda``) and never
  moves to the CPU on its own.
"""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu_torch as tvdf
from vid_dup_finder_lib_tpu_torch.cache import VideoHashFilesystemCache
from vid_dup_finder_lib_tpu_torch.models.pipeline import hash_raw_frames_device, hash_videos
from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk
from vid_dup_finder_lib_tpu_torch.ops.hamming import banded_adjacency, refs_adjacency
from vid_dup_finder_lib_tpu_torch.utils import cuda_build
from vid_dup_finder_lib_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vid_dup_finder_lib_tpu_torch")


def _run(code_or_args, cwd=REPO, timeout=120):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def _skip_if_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for CUDA-less hosts")


def test_port_runs_with_jax_unimportable():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import importlib, pkgutil
        import numpy as np, torch
        import vid_dup_finder_lib_tpu_torch as vdf
        for m in pkgutil.walk_packages(vdf.__path__, vdf.__name__ + "."):
            importlib.import_module(m.name)
        from vid_dup_finder_lib_tpu_torch.ops.hash_kernel import hash_cubes
        rng = np.random.default_rng(0)
        cubes = rng.integers(0, 256, (4, 16, 16, 16), dtype=np.uint8)
        words = hash_cubes(torch.from_numpy(cubes)).numpy().view(np.uint32)
        hashes = vdf.VideoHash.many_from_packed_u32(
            np.concatenate([words, words]), [f"v{i}" for i in range(8)], [60] * 8)
        groups = vdf.search(hashes, 0.35, backend="device", device="cpu")
        assert sorted(len(g) for g in groups) == [2, 2, 2, 2], groups
        assert not any(k == "jax" or k.startswith("jax.")
                       for k, v in sys.modules.items() if v is not None)
        print("port-ok")
        """
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "port-ok" in r.stdout


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    scanned = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                scanned.append(os.path.relpath(os.path.join(root, f), PORT))
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f
    # the multi-device layer is among them
    assert {"parallel/mesh.py", "parallel/ring_cuda.py", "parallel/refs_sharded.py",
            "parallel/sharded_search.py"} <= set(scanned)


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import)\s+vid_dup_finder_lib_tpu\b(?!_torch)", re.M
)


def test_port_sources_never_import_the_jax_package():
    sources = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(sources) > 40
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert not _JAX_PACKAGE_IMPORT.search(text), path
    # the pattern does catch each form of such an import
    for line in ("import vid_dup_finder_lib_tpu", "from vid_dup_finder_lib_tpu import x",
                 "  from vid_dup_finder_lib_tpu.search import Search",
                 "import vid_dup_finder_lib_tpu.ops.golden as g"):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    assert not _JAX_PACKAGE_IMPORT.search("from vid_dup_finder_lib_tpu_torch import x")


def test_port_runs_with_jax_and_the_jax_package_unimportable(tmp_path):
    """Every module of the port imports, and search (every backend), the
    references search (per reference, batched and over a resident
    library), hashing, the cache and the CLI (its device from
    ``VDF_TORCH_DEVICE``) run, with neither ``jax`` nor
    ``vid_dup_finder_lib_tpu`` importable."""
    from tests.fixtures import make_fixture_videos

    data = os.path.join(REPO, "tests", "data")
    make_fixture_videos(data)
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        sys.modules["vid_dup_finder_lib_tpu"] = None
        import contextlib, importlib, io, json, pkgutil, runpy
        import numpy as np
        import vid_dup_finder_lib_tpu_torch as vdf
        for m in pkgutil.walk_packages(vdf.__path__, vdf.__name__ + "."):
            importlib.import_module(m.name)
        from vid_dup_finder_lib_tpu_torch.cache import VideoHashFilesystemCache
        from vid_dup_finder_lib_tpu_torch.models.pipeline import hash_videos
        from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
        from vid_dup_finder_lib_tpu_torch import native
        from vid_dup_finder_lib_tpu_torch.search import BACKENDS

        rng = np.random.default_rng(3)
        packed = rng.integers(0, 2**32, (400, 32), dtype=np.uint64).astype(np.uint32)
        packed[1::2] = packed[::2]
        durs = np.repeat(np.sort(rng.integers(30, 7200, 200)), 2)
        paths = [f"v{{i}}" for i in range(400)]
        hashes = vdf.VideoHash.many_from_packed_u32(packed, paths, durs)
        assert "native" in BACKENDS and native.available()
        for backend in BACKENDS:
            groups = vdf.search(hashes, 0.35, backend=backend, device="cpu")
            assert len(groups) == 200, (backend, len(groups))
        # the native sweeps themselves: the banded one, the windowed
        # references one (which the batched search below takes) and the
        # one-to-many distances of search_one
        ni, nj = native.banded_adjacency_native(
            packed.view(np.uint64), np.full(400, 400), 0)
        assert (ni.tolist(), nj.tolist()) == (list(range(0, 400, 2)), list(range(1, 400, 2)))
        ri, rj = native.refs_windowed_native(
            packed[:2].view(np.uint64), packed.view(np.uint64), [0, 0], [400, 400], 0)
        assert (ri.tolist(), rj.tolist()) == ([0, 0, 1, 1], [0, 1, 0, 1])
        assert native.distances_one_native(packed[0], packed[:3]).tolist()[:2] == [0, 0]
        assert native.count_leq_native(packed.view(np.uint64), np.full(400, 400), 0) == 200
        lib = IncrementalDeviceLibrary("cpu")
        lib.append(packed)
        for refs in (hashes[::40], hashes[::5]):  # per reference, batched
            refs = [h.with_src_path("r" + h.src_path) for h in refs]
            found = vdf.search_with_references(refs, hashes, 0.35, device="cpu")
            assert len(found) == len(refs)
            assert found == vdf.search_with_references(
                refs, hashes, 0.35, device="cpu", device_library=lib, library_paths=paths)

        videos = sorted(f"{data}/" + f for f in ("cat.1.mp4", "cat.2.mp4", "dog.1.mp4"))
        hashed = hash_videos(videos, device="cpu")
        assert all(isinstance(hashed[v], vdf.VideoHash) for v in videos)
        cache = VideoHashFilesystemCache("{tmp_path}/c.json", device="cpu")
        assert cache.update_using_fs(videos) == 3
        assert [h.hash_bits().tolist() for h in cache.fetch_hashes(videos)] == (
            [hashed[v].hash_bits().tolist() for v in videos])
        sys.argv = ["vid-dup-finder", "--files", "{data}", "--cache-file",
                    "{tmp_path}/cli.json", "--cropdetect", "letterbox", "--output-format", "json"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.suppress(SystemExit):
            runpy.run_module("vid_dup_finder_lib_tpu_torch.app", run_name="__main__")
        assert sorted(len(g["duplicates"]) for g in json.loads(out.getvalue())) == [3, 3]
        loaded = [k for k, v in sys.modules.items() if v is not None and (
            k.split(".")[0] in ("jax", "vid_dup_finder_lib_tpu"))]
        assert not loaded, loaded
        print("standalone-ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["VDF_TORCH_DEVICE"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr
    assert "standalone-ok" in r.stdout


def test_chip_smoke_fails_without_cuda():
    _skip_if_cuda()
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_cuda_request_without_cuda_raises():
    _skip_if_cuda()
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tvdf.search([], device=torch.device("cuda"))
    with pytest.raises(RuntimeError):
        hash_videos([], device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_default_device_is_torch_default():
    """No device means the card, whatever torch's default device is: the
    CPU is used only when the caller names it."""
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", torch.cuda.current_device())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_entry_points_without_device_raise_without_cuda(tmp_path):
    """Every public entry point called with no device asks for the card,
    and raises on a host without one instead of running on the CPU."""
    _skip_if_cuda()
    hashes = tvdf.VideoHash.many_from_packed_u32(
        np.zeros((2, 32), np.uint32), ["a", "b"], [10, 10])
    calls = (
        lambda: tvdf.search(hashes, 0.35),
        lambda: tvdf.Search(hashes),
        lambda: tvdf.search_with_references(hashes[:1], hashes, 0.35),
        lambda: hash_videos([]),
        lambda: hc.IncrementalDeviceLibrary(),
        lambda: VideoHashFilesystemCache(tmp_path / "cache"),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for on the CPU")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    counters = (hk.hash_cubes, hc.band_counts, hc.band_pack, hb.band_sweep)
    before = [f.launches for f in counters]
    rng = np.random.default_rng(1)
    cubes = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 16), dtype=np.uint8))
    np.testing.assert_array_equal(hk.hash_cubes(cubes), hk.hash_cubes_plain(cubes))
    packed = rng.integers(0, 2**32, (300, 32), dtype=np.uint64).astype(np.uint32)
    packed[1] = packed[0]
    bounds = np.full(300, 300)
    for backend in ("device", "band"):
        i, j = banded_adjacency(packed, bounds, 0, backend=backend, device="cpu")
        assert (i.tolist(), j.tolist()) == ([0], [1])
    i, j = refs_adjacency(packed[:1], packed, [1], [300], 0, device="cpu")
    assert (i.tolist(), j.tolist()) == ([0], [1])
    lib = hc.IncrementalDeviceLibrary("cpu")
    lib.append(packed)
    st = lib.state(np.arange(300), bounds)
    i, j = hc.banded_adjacency_cuda(st, 0)
    assert (i.tolist(), j.tolist()) == ([0], [1])
    assert hb.banded_adjacency_band(None, None, 0, state=st)[0].tolist() == [0]
    frames = torch.from_numpy(rng.integers(0, 256, (2, 16, 20, 30), dtype=np.uint8))
    assert hash_raw_frames_device(frames).shape == (2, 32)
    assert [f.launches for f in counters] == before


_CLI = (
    "import runpy, sys\n"
    "{block}"
    "sys.argv = ['vid-dup-finder'] + sys.argv[1:]\n"
    "runpy.run_module('vid_dup_finder_lib_tpu_torch.app', run_name='__main__')\n"
)


def _cli(tmp_path, device, block_jax=False):
    data = os.path.join(REPO, "tests", "data")
    code = _CLI.format(block="sys.modules['jax'] = None\n" if block_jax else "")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTHONPATH") and k != "VDF_TORCH_DEVICE"}
    if device is not None:
        env["VDF_TORCH_DEVICE"] = device
    return subprocess.run(
        [sys.executable, "-c", code, "--files", data, "--cache-file",
         str(tmp_path / "cache.json"), "--cropdetect", "letterbox",
         "--output-format", "json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_cli_and_library_search_run_with_jax_unimportable(tmp_path):
    from tests.fixtures import make_fixture_videos

    make_fixture_videos(os.path.join(REPO, "tests", "data"))
    r = _cli(tmp_path, "cpu", block_jax=True)
    assert r.returncode == 0, r.stderr
    groups = json.loads(r.stdout)
    assert sorted(len(g["duplicates"]) for g in groups) == [3, 3]
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import vid_dup_finder_lib_tpu_torch as vdf
        from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
        from vid_dup_finder_lib_tpu_torch.search import BACKENDS
        rng = np.random.default_rng(3)
        packed = rng.integers(0, 2**32, (400, 32), dtype=np.uint64).astype(np.uint32)
        packed[1::2] = packed[::2]
        durs = np.repeat(np.sort(rng.integers(30, 7200, 200)), 2)
        hashes = vdf.VideoHash.many_from_packed_u32(packed, [f"v{i}" for i in range(400)], durs)
        perm = rng.permutation(400)
        lib = IncrementalDeviceLibrary("cpu", capacity=128)
        for k0 in range(0, 400, 150):
            lib.append(packed[perm[k0 : k0 + 150]])
        paths = [f"v{i}" for i in perm]
        for backend in ("auto", "band"):
            groups = vdf.search(hashes, 0.35, backend=backend, device="cpu",
                                device_library=lib, library_paths=paths)
            assert len(groups) == 200, len(groups)
        refs = [h.with_src_path(f"r{i}") for i, h in enumerate(hashes[::40])]
        found = vdf.search_with_references(refs, hashes, 0.35, device="cpu",
                                           device_library=lib, library_paths=paths)
        assert len(found) == len(refs)
        assert not any(v is not None for k, v in sys.modules.items()
                       if k == "jax" or k.startswith("jax."))
        print("library-ok")
        """
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "library-ok" in r.stdout


def test_cli_without_cuda_raises_unless_told_cpu(tmp_path):
    _skip_if_cuda()
    r = _cli(tmp_path, None)
    assert r.returncode != 0
    assert "is_available() is False" in r.stderr
    assert not (tmp_path / "cache.json").exists()
    r = _cli(tmp_path, "cuda")
    assert r.returncode != 0 and "is_available() is False" in r.stderr


def test_kernel_build_without_nvcc_raises():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        cuda_build.load_library()


# -- the port's copies of the JAX package's host code --------------------------


def _batch(n, seed, paths=None, durations=None):
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    paths = paths if paths is not None else [f"/v/{i:04d}" for i in range(n)]
    durations = durations if durations is not None else rng.integers(30, 300, n)
    return packed, list(paths), list(durations)


def test_many_from_packed_u32_hands_out_a_read_only_view():
    """Fault in the reference: its batch's ``packed_u32`` is the caller's
    matrix itself, writable, so a write through the batch changes the
    hashes behind it.  The port's is a read-only view."""
    from vid_dup_finder_lib_tpu import VideoHash as JaxVideoHash

    packed, paths, durs = _batch(6, 1)
    theirs = JaxVideoHash.many_from_packed_u32(packed, paths, durs)
    assert theirs.packed_u32.flags.writeable  # the fault
    batch = tvdf.VideoHash.many_from_packed_u32(packed, paths, durs)
    assert not batch.packed_u32.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        batch.packed_u32[0, 0] = 0
    np.testing.assert_array_equal(batch.packed_u32, packed)
    for h, row in zip(batch, packed):
        np.testing.assert_array_equal(h.packed_u32(), row)
        assert not h.hash.flags.writeable


def test_non_ascii_paths_keep_the_batch_matrix(monkeypatch):
    """Fault in the reference: a non-ASCII path sends ``Search.__init__``
    to its Python-key sort, which drops the batch's packed matrix, so the
    search rebuilds it hash by hash.  The port sorts the matrix with the
    entries, and the groups are unchanged."""
    import vid_dup_finder_lib_tpu as jvdf
    from tests.test_torch_search import jax_hashes, same_groups
    search_mod = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")

    packed, _, _ = _batch(300, 2)
    packed[1::2] = packed[::2]
    paths = [f"/v/{'é' if i % 3 else 'e'}{299 - i:04d}" for i in range(300)]
    durs = [60 + (i // 2) % 7 for i in range(300)]
    batch = tvdf.VideoHash.many_from_packed_u32(packed, paths, durs)
    s = tvdf.Search(batch, device="cpu")
    assert s._ctor_resorted is None  # the Python-key sort, as in the JAX package
    assert s._packed_mat is not None
    np.testing.assert_array_equal(
        s._packed_mat, np.stack([e.packed_u32() for e in s.entries])
    )
    assert jvdf.Search(jax_hashes(batch))._packed_mat is None  # the fault
    want = tvdf.search(list(batch), 0.35, backend="host", device="cpu")
    monkeypatch.setattr(
        search_mod, "hashes_to_matrix",
        lambda *a: pytest.fail("the matrix was rebuilt from the entries"),
    )
    for backend in ("host", "device", "band"):
        got = tvdf.search(batch, 0.35, backend=backend, device="cpu")
        assert got == want and len(got) == 150
    assert same_groups(want, jvdf.search(jax_hashes(batch), 0.35, backend="host"))


_SORT_PATHS = [
    "/v/b", "/v/a", "/v/\udcff", "/v/\udc80x", "/v/é", "/v/ü", "/v/Z", "/v/z",
    "/v/a/b", "/v/a b", "/v/中", "/v/\U0001f600", "/v/é",
]


@pytest.mark.parametrize("durations", ["equal", "mixed"])
def test_sort_key_order_matches_the_jax_package(durations):
    """Bytewise (duration, path) order over non-ASCII and surrogate-escaped
    paths: the port's entries come in the JAX package's order."""
    import vid_dup_finder_lib_tpu as jvdf
    from tests.test_torch_search import jax_hashes
    from vid_dup_finder_lib_tpu_torch.search import _sort_key

    n = len(_SORT_PATHS)
    durs = [60] * n if durations == "equal" else [60 + k % 3 for k in range(n)]
    packed, _, _ = _batch(n, 3)
    ours = tvdf.VideoHash.many_from_packed_u32(packed, _SORT_PATHS, durs)
    got = [e.src_path for e in tvdf.Search(ours, device="cpu").entries]
    assert got == [e.src_path for e in jvdf.Search(jax_hashes(ours)).entries]
    assert got == [h.src_path for h in sorted(ours, key=_sort_key)]
    assert got == [
        p for _, p in sorted(zip(durs, _SORT_PATHS), key=lambda t: (t[0], os.fsencode(t[1])))
    ]


def _flip_bits(words, bits):
    words = words.copy()
    for b in bits:
        words[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return words


@pytest.mark.parametrize("backend", ["auto", "device", "band", "host", "naive"])
def test_greedy_replay_on_a_chain_matches_the_jax_package(backend):
    """A chain of ten hashes, each 200 bits from the next and so every
    second one 400 apart (over a tolerance of 350): the greedy consume
    takes b into a's group, which leaves c to start its own with d, and so
    on.  The last five are the first five with every bit flipped, which
    puts /o/a 200 bits from /c/e; their durations step by about 10%, so
    the windows decide which links count."""
    import vid_dup_finder_lib_tpu as jvdf
    from tests.test_torch_search import jax_hashes, same_groups

    rng = np.random.default_rng(4)
    base = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    order = rng.permutation(1000)
    chain = [base]
    for k in range(4):
        chain.append(_flip_bits(chain[-1], order[200 * k : 200 * (k + 1)]))
    other = [_flip_bits(c, range(1000)) for c in chain]
    packed = np.stack(chain + other)
    paths = [f"/c/{x}" for x in "abcde"] + [f"/o/{x}" for x in "abcde"]
    durs = [100] * 5 + [100, 110, 110, 111, 121]
    ours = tvdf.VideoHash.many_from_packed_u32(packed, paths, durs)
    got = tvdf.search(ours, 0.35, backend=backend, device="cpu")
    assert same_groups(got, jvdf.search(jax_hashes(ours), 0.35, backend="naive"))
    assert [g.duplicates for g in got] == [
        ("/o/e", "/o/d"), ("/o/c", "/o/b"), ("/o/a", "/c/e"), ("/c/d", "/c/c"),
        ("/c/b", "/c/a"),
    ]


def test_duration_slice_edges_match_the_jax_package():
    """The [0.95 d, 1.05 d] windows at their integer edges, on ties, below
    and above every duration, and on an empty Search."""
    import vid_dup_finder_lib_tpu as jvdf
    from tests.test_torch_search import jax_hashes

    durs = [0, 1, 19, 20, 20, 21, 95, 100, 100, 100, 105, 106, 1000, 1049, 1050, 1051]
    packed, _, _ = _batch(len(durs), 5)
    ours = tvdf.VideoHash.many_from_packed_u32(
        packed, [f"/v/{i:02d}" for i in range(len(durs))], durs
    )
    s, j = tvdf.Search(ours, device="cpu"), jvdf.Search(jax_hashes(ours))
    probes = sorted(set(durs) | {d + k for d in durs for k in (-1, 1)} | {-5, 2000, 10**6})
    got = [s._duration_slice(d) for d in probes]
    assert got == [j._duration_slice(d) for d in probes]
    assert s._duration_slice(100) == (durs.index(95), durs.index(106))
    assert s._duration_slice(20) == (durs.index(19), durs.index(21) + 1)
    assert s._duration_slice(10**6) == (len(durs), len(durs))
    assert tvdf.Search([], device="cpu")._duration_slice(100) == (0, 0)
    assert jvdf.Search([])._duration_slice(100) == (0, 0)


# -- every import inside the port has a target, and the last host copies --------


def _port_modules():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _missing_relative_targets(path, text):
    """``(line, what)`` for each relative import in the source ``text`` of
    ``path`` whose module has no file in the port, and each name imported
    from a package that is neither a module file, a subpackage nor a name
    bound in that package's ``__init__``."""
    import ast

    missing = []
    here = os.path.dirname(path)
    for node in ast.walk(ast.parse(text)):
        if not isinstance(node, ast.ImportFrom) or node.level == 0:
            continue
        base = here
        for _ in range(node.level - 1):
            base = os.path.dirname(base)
        target = os.path.join(base, *(node.module.split(".") if node.module else []))
        if os.path.isfile(target + ".py"):
            continue
        init = os.path.join(target, "__init__.py")
        if not os.path.isfile(init):
            missing.append((node.lineno, "." * node.level + (node.module or "")))
            continue
        with open(init, encoding="utf-8") as fh:
            bound = _bound_names(ast.parse(fh.read()))
        for alias in node.names:
            sub = os.path.join(target, alias.name)
            if not (os.path.isfile(sub + ".py") or os.path.isdir(sub)
                    or alias.name in bound or alias.name == "*"):
                missing.append((node.lineno, f"{'.' * node.level}{node.module or ''}:{alias.name}"))
    return sorted(missing)


def _bound_names(tree):
    import ast

    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def test_every_relative_import_in_the_port_has_a_target():
    """Also those inside functions, which importing the module never runs
    (the resolver's ``from ..utils.modulo import`` was one)."""
    modules = _port_modules()
    assert len(modules) > 40
    for path in modules:
        with open(path, encoding="utf-8") as fh:
            assert _missing_relative_targets(path, fh.read()) == [], path
    # the check does catch a module, and a name of a package, that is not there
    probe = os.path.join(PORT, "app", "resolver_tui.py")
    text = ("def f():\n    from ..utils.nowhere import x\n"
            "from ..utils import modulo, nothing_here\nfrom . import resolver_web\n"
            "from .. import VideoHash, ops\n")
    assert _missing_relative_targets(probe, text) == [
        (2, "..utils.nowhere"), (3, "..utils:nothing_here")]


def test_every_jax_package_host_module_has_a_counterpart():
    """The JAX package's modules that import neither jax nor its Pallas or
    mesh code each have a file of the same name in the port, apart from
    those the port replaces under another design; so does every module of
    its multi-device layer (``parallel/``), the ring under the name of the
    port's kernels (``ring_pallas.py`` -> ``ring_cuda.py``)."""
    jax_root = os.path.join(REPO, "vid_dup_finder_lib_tpu")
    replaced = {"utils/jaxconfig.py", "__main__.py"}
    renamed = {"parallel/ring_pallas.py": "parallel/ring_cuda.py"}
    device_code = re.compile(r"^\s*(import|from)\s+(jax|\.+(parallel|native|ops\.hamming_pallas"
                             r"|ops\.hash_pallas|utils\.jaxconfig))\b", re.M)
    absent, parallel = [], []
    for root, _, files in os.walk(jax_root):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), jax_root)
            if not f.endswith(".py") or rel in replaced:
                continue
            if rel.startswith("parallel"):
                parallel.append(rel)
            else:
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    if device_code.search(fh.read()):
                        continue
            if not os.path.isfile(os.path.join(PORT, renamed.get(rel, rel))):
                absent.append(rel)
    assert absent == []
    assert len(parallel) == 5


def _same_source_after_the_docstring(rel):
    """The port's copy of a host module is the original's code, line for
    line, under a docstring of its own that names the counterpart."""
    import ast

    bodies = []
    for package in ("vid_dup_finder_lib_tpu", "vid_dup_finder_lib_tpu_torch"):
        with open(os.path.join(REPO, package, rel), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        assert ast.get_docstring(tree)
        bodies.append(ast.dump(ast.Module(body=tree.body[1:], type_ignores=[])))
    with open(os.path.join(PORT, rel), encoding="utf-8") as fh:
        assert f"vid_dup_finder_lib_tpu/{rel}" in ast.get_docstring(ast.parse(fh.read()))
    return bodies[0] == bodies[1]


@pytest.mark.parametrize("rel", ["utils/modulo.py", "ops/compositing.py", "debug_util.py"])
def test_last_host_copies_keep_the_original_code(rel):
    assert _same_source_after_the_docstring(rel)


def test_native_runtime_is_the_original_apart_from_its_build():
    """``native_src/vdf_native.cpp`` is the original byte for byte, and
    ``native.py`` the original's code apart from ``_build_lib`` (its own
    temporary file per building process, a default cache in the checkout)
    and the helper that chooses that cache."""
    import ast

    rel = os.path.join("native_src", "vdf_native.cpp")
    with open(os.path.join(REPO, "vid_dup_finder_lib_tpu", rel), "rb") as fh:
        original = fh.read()
    with open(os.path.join(PORT, rel), "rb") as fh:
        assert fh.read() == original
    repaired = {"_build_lib", "_default_cache_dir"}
    bodies = []
    for package in ("vid_dup_finder_lib_tpu", "vid_dup_finder_lib_tpu_torch"):
        with open(os.path.join(REPO, package, "native.py"), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        assert ast.get_docstring(tree)
        kept = [node for node in tree.body[1:]
                if not (isinstance(node, ast.FunctionDef) and node.name in repaired)]
        assert len(kept) == len(tree.body) - 1 - (1 if package.endswith("tpu") else 2)
        bodies.append(ast.dump(ast.Module(body=kept, type_ignores=[])))
    assert bodies[0] == bodies[1]
    with open(os.path.join(PORT, "native.py"), encoding="utf-8") as fh:
        text = fh.read()
    assert "vid_dup_finder_lib_tpu/native.py" in ast.get_docstring(ast.parse(text))
    assert "os.getpid()" in text and '".tmp"' not in text


def test_modulo_matches_the_jax_package():
    from vid_dup_finder_lib_tpu.utils import modulo as theirs
    from vid_dup_finder_lib_tpu_torch.utils import modulo as ours

    for m in (1, 2, 3, 7):
        for v in range(-15, 16):
            assert ours.modulo(v, m) == theirs.modulo(v, m) == v % m
            for d in (0, 1, 5, 22):
                assert ours.wrapping_add(v, d, m) == theirs.wrapping_add(v, d, m)
                assert ours.wrapping_sub(v, d, m) == theirs.wrapping_sub(v, d, m)
    assert ours.wrapping_sub(0, 1, 3) == 2 and ours.wrapping_add(2, 1, 3) == 0
    with pytest.raises(AssertionError):
        ours.modulo(1, 0)


@pytest.mark.parametrize("pad", [0, 3])
def test_compositing_matches_the_jax_package(pad):
    from vid_dup_finder_lib_tpu.ops import compositing as theirs
    from vid_dup_finder_lib_tpu_torch.ops import compositing as ours

    rng = np.random.default_rng(6 + pad)
    shapes = [(5, 7), (9, 4), (1, 1), (6, 6)]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    for name in ("row_images", "stack_images"):
        got = getattr(ours, name)(images, pad)
        np.testing.assert_array_equal(got, getattr(theirs, name)(images, pad))
        assert got.dtype == np.uint8
    assert ours.row_images(images, pad).shape == (9, 18 + 3 * pad, 3)
    assert ours.stack_images(images, pad).shape == (21 + 3 * pad, 7, 3)
    rows = [images[:2], images[2:]]
    np.testing.assert_array_equal(
        ours.grid_images_rgb(rows, pad), theirs.grid_images_rgb(rows, pad))
    with pytest.raises(AssertionError):
        ours.row_images([])


def test_debug_util_matches_the_jax_package(tmp_path):
    """``dump_hash_frames`` of a fixture video and ``hash_bit_image`` of a
    seeded hash: the same summary and byte-equal image files."""
    import vid_dup_finder_lib_tpu as jvdf
    from tests.fixtures import make_fixture_videos
    from vid_dup_finder_lib_tpu import debug_util as theirs
    from vid_dup_finder_lib_tpu_torch import debug_util as ours

    video = make_fixture_videos(os.path.join(REPO, "tests", "data"))[0]
    want = theirs.dump_hash_frames(
        video, str(tmp_path / "jax"),
        jvdf.CreationOptions(cropdetect=jvdf.Cropdetect.LETTERBOX))
    got = ours.dump_hash_frames(
        video, str(tmp_path / "port"),
        tvdf.CreationOptions(cropdetect=tvdf.Cropdetect.LETTERBOX))
    names = [os.path.basename(p) for p in got.pop("files")]
    assert names == [os.path.basename(p) for p in want.pop("files")] and len(names) == 48
    assert got == want and got["num_frames"] == 16
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()

    words = np.random.default_rng(8).integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    words[-1] &= np.uint32(0xFF)
    theirs.hash_bit_image(jvdf.VideoHash.from_packed_u32(words), str(tmp_path / "jax.png"))
    ours.hash_bit_image(tvdf.VideoHash.from_packed_u32(words), str(tmp_path / "port.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
