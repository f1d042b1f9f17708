"""The port stands apart from JAX, and never swaps the CPU in for a device.

* Importing and running the port works with ``jax`` made unimportable.
* ``chip_smoke.py`` fails, and prints no result, on a host without CUDA,
  and also when it is alone in a directory.
* A CPU tensor goes to a kernel's plain version without touching the
  kernel library; asking for ``cuda`` without CUDA raises.
"""

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
from vid_dup_finder_lib_tpu_torch.models.pipeline import hash_videos
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
    assert [f.launches for f in counters] == before


def test_kernel_build_without_nvcc_raises():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        cuda_build.load_library()
