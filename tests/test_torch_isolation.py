"""The port stands apart from JAX, and never swaps the CPU in for a device.

* Importing and running the port works with ``jax`` made unimportable.
* ``chip_smoke.py`` fails, and prints no result, on a host without CUDA,
  and also when it is alone in a directory.
* A CPU tensor goes to a kernel's plain version without touching the
  kernel library; asking for ``cuda`` without CUDA raises.
* The CLI and the library search run with ``jax`` unimportable; the CLI
  takes its device from ``VDF_TORCH_DEVICE`` (default ``cuda``) and never
  moves to the CPU on its own.
"""

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
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not pattern.search(fh.read()), f


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
    assert resolve_device(None) == torch.get_default_device()
    assert resolve_device("cpu") == torch.device("cpu")


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
