"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (the kernels are
built from ``vid_dup_finder_lib_tpu_torch/csrc`` at first use) and skips
elsewhere.  Run them on a GPU host with

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_hamming import LIBRARIES, _library
from tests.test_torch_refs import CASES
from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels run only on the card")
    return torch.device("cuda")


def test_hash_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    cubes = torch.from_numpy(
        rng.integers(0, 256, (300, 16, 16, 16), dtype=np.uint8)
    ).to(dev)
    before = hk.hash_cubes.launches
    got = hk.hash_cubes(cubes)
    assert hk.hash_cubes.launches == before + 1
    want = hk.hash_cubes_plain(cubes)
    torch.cuda.synchronize()
    d = np.bitwise_count((got ^ want).cpu().numpy().view(np.uint32)).sum(1)
    assert d.max() <= 2 and d.sum() <= 8, (d.max(), d.sum())
    assert not (got[:, -1].cpu().numpy().view(np.uint32) >> 8).any()


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", [n for n in LIBRARIES if n != "empty"])
def test_band_kernels_match_plain(dev, name, tol):
    packed, bounds = _library(name)
    st = hc.SearchState(packed, bounds, dev)
    counts = hc.band_counts(st, tol)
    torch.cuda.synchronize()
    assert torch.equal(counts, hc.band_counts_plain(st, tol))
    hits = hc.hit_tiles(st, counts)
    words = hc.band_pack(st, hits, tol)
    torch.cuda.synchronize()
    assert torch.equal(words, hc.band_pack_plain(st, hits, tol))
    ki, kj = hc.banded_adjacency_cuda(st, tol)
    pi, pj = hc.banded_adjacency_plain(st, tol)
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kj, pj)


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", [n for n in LIBRARIES if n != "empty"])
def test_band_sweep_matches_plain(dev, name, tol):
    packed, bounds = _library(name)
    st = hc.SearchState(packed, bounds, dev)
    for rt0, rt1 in hb.band_ranges(st, 3):
        before = hb.band_sweep.launches
        counts, words = hb.band_sweep(st, tol, rt0, rt1)
        torch.cuda.synchronize()
        assert hb.band_sweep.launches == before + 1
        want_counts, want_words = hb.band_sweep_plain(st, tol, rt0, rt1)
        assert torch.equal(counts, want_counts)
        r, s = torch.nonzero(counts, as_tuple=True)
        idx = hb.tile_offsets(st, rt0, rt1)[r] + s
        assert torch.equal(words[idx], want_words[idx])
    ki, kj = hb.banded_adjacency_band(None, None, tol, state=st)
    pi, pj = hc.banded_adjacency_plain(st, tol)
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kj, pj)


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("case", list(CASES))
def test_window_mode_kernels_match_plain(dev, case, tol):
    st = hc.RefsState(*CASES[case](), dev)
    counts = hc.band_counts(st, tol)
    torch.cuda.synchronize()
    assert torch.equal(counts, hc.band_counts_plain(st, tol))
    hits = hc.hit_tiles(st, counts)
    words = hc.band_pack(st, hits, tol)
    torch.cuda.synchronize()
    assert torch.equal(words, hc.band_pack_plain(st, hits, tol))
    ki, kj = hc.refs_adjacency_cuda(st, tol)
    pi, pj = hc.refs_adjacency_plain(st, tol)
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kj, pj)


def _hashes():
    hashes = [tvdf.VideoHash.random_hash(np.random.default_rng(i)) for i in range(600)]
    hashes = [h.with_src_path(f"v{i}").with_duration(60 + i // 50)
              for i, h in enumerate(hashes)]
    return hashes + [h.with_src_path(h.src_path + "_dup") for h in hashes[::7]]


@pytest.mark.parametrize("backend", ["device", "band"])
def test_search_on_cuda_equals_cpu(dev, backend):
    hashes = _hashes()
    assert tvdf.search(hashes, 0.35, backend=backend, device=dev) == tvdf.search(
        hashes, 0.35, backend=backend, device="cpu"
    )


def test_search_with_references_on_cuda_equals_cpu(dev):
    hashes = _hashes()
    refs = [h.with_src_path(f"r{i}") for i, h in enumerate(hashes[::6])]
    assert len(refs) >= 64
    got = tvdf.search_with_references(refs, hashes, 0.35, device=dev)
    assert got == tvdf.search_with_references(refs, hashes, 0.35, device="cpu")
    assert len(got) == len(refs)


def test_wrapper_rejects_strided_input(dev):
    cubes = torch.zeros((4, 16, 16, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        hk.hash_cubes(cubes.transpose(2, 3))
