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
from tests.test_torch_preproc import RESIZE_CASES, _golden_cubes, _letterbox_frames, _raw_batch
from tests.test_torch_refs import CASES
from vid_dup_finder_lib_tpu.ops.letterbox import cropdetect_letterbox
from vid_dup_finder_lib_tpu_torch.models.pipeline import hash_raw_frames_device
from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk
from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
from vid_dup_finder_lib_tpu_torch.ops.letterbox_device import cropdetect_letterbox_device
from vid_dup_finder_lib_tpu_torch.ops.resize_device import resize_frames_device

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


def _library_on(dev, hashes, shuffled):
    rng = np.random.default_rng(4)
    rows = [hashes[k] for k in rng.permutation(len(hashes))] if shuffled else sorted(
        hashes, key=lambda h: (h.duration, h.src_path.encode())
    )
    lib = IncrementalDeviceLibrary(dev, capacity=256)
    for k0 in range(0, len(rows), 200):  # grows across capacity doublings
        lib.append(np.stack([h.packed_u32() for h in rows[k0 : k0 + 200]]))
    return lib, [h.src_path for h in rows] if shuffled else None


@pytest.mark.parametrize("backend", ["device", "band"])
@pytest.mark.parametrize("shuffled", [True, False])
def test_library_search_on_cuda_equals_cpu(dev, backend, shuffled):
    hashes = _hashes()
    lib, paths = _library_on(dev, hashes, shuffled)
    counters = (hc.band_counts, hc.band_pack, hb.band_sweep)
    before = [f.launches for f in counters]
    got = tvdf.search(hashes, 0.35, backend=backend, device=dev,
                      device_library=lib, library_paths=paths)
    launched = [f.launches - b for f, b in zip(counters, before)]
    assert got == tvdf.search(hashes, 0.35, backend=backend, device="cpu")
    assert launched[2] > 0 if backend == "band" else launched[0] > 0 and launched[1] > 0
    if not shuffled:
        s = tvdf.Search(hashes, device=dev)
        s.attach_device_library(lib, None)
        st = lib.state(s._library_order, s._self_search_bounds())
        assert st.packed.data_ptr() == lib.packed.data_ptr()


def test_library_refs_on_cuda_equals_cpu(dev):
    hashes = _hashes()
    refs = [h.with_src_path(f"r{i}") for i, h in enumerate(hashes[::6])]
    for shuffled in (True, False):
        lib, paths = _library_on(dev, hashes, shuffled)
        got = tvdf.search_with_references(refs, hashes, 0.35, device=dev,
                                          device_library=lib, library_paths=paths)
        assert got == tvdf.search_with_references(refs, hashes, 0.35, device="cpu")


def test_library_on_cuda_refuses_a_cpu_search(dev):
    hashes = _hashes()
    lib, paths = _library_on(dev, hashes, True)
    with pytest.raises(ValueError, match="lies on cuda"):
        tvdf.search(hashes, 0.35, device="cpu", device_library=lib, library_paths=paths)


def test_resize_bit_exact_on_cuda_with_tf32_enabled(dev):
    """The caller turns TF32 on for the whole process; the resize's scoped
    guard must still give the golden cubes, and leave TF32 on."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for case in RESIZE_CASES.values():
            (h, w), crop = case
            frames = np.random.default_rng(2).integers(0, 256, (4, 16, h, w), dtype=np.uint8)
            got = resize_frames_device(torch.from_numpy(frames).to(dev), crop)
            np.testing.assert_array_equal(got.cpu().numpy(), _golden_cubes(frames, [crop] * 4))
            assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved)


def test_preproc_on_cuda_equals_cpu(dev):
    frames = _letterbox_frames()
    crops = cropdetect_letterbox_device(torch.from_numpy(frames).to(dev))
    assert crops == cropdetect_letterbox_device(torch.from_numpy(frames))
    raw = _raw_batch()
    before = hk.hash_cubes.launches
    got = hash_raw_frames_device(raw, device=dev)
    assert hk.hash_cubes.launches == before + 1
    host_crops = [cropdetect_letterbox(list(v)) for v in raw]
    want = hk.hash_cubes_plain(torch.from_numpy(_golden_cubes(raw, host_crops)))
    d = np.bitwise_count((got.cpu() ^ want).numpy().view(np.uint32)).sum(1)
    assert d.max() <= 2, d


# -- K2 on the tensor cores: counts equal to the plain version's -------------


def _flip_exactly(words, rng, count):
    """``words`` with exactly ``count`` of its 1024 storage bits flipped
    (pad bits included)."""
    words = words.copy()
    for b in rng.choice(1024, count, replace=False):
        words[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return words


def _planted_at(n, tol, seed):
    """n hashes with random nonzero pad bits; every fifth row is followed
    by a copy at Hamming distance exactly ``tol`` and then one at
    ``tol + 1`` (both capped at 1024); durations narrow enough that every
    band spans several column tiles."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] |= rng.integers(1, 2**24, n, dtype=np.uint64).astype(np.uint32) << np.uint32(8)
    for s in range(0, n - 2, 5):
        packed[s + 1] = _flip_exactly(packed[s], rng, min(max(tol, 0), 1024))
        packed[s + 2] = _flip_exactly(packed[s], rng, min(max(tol + 1, 0), 1024))
    durs = np.sort(rng.integers(100, 130, n))
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), side="right")
    return packed, bounds


def _k2_equal(st, tol):
    before = hc.band_counts.launches
    got = hc.band_counts(st, tol)
    torch.cuda.synchronize()
    assert hc.band_counts.launches == before + 1
    want = hc.band_counts_plain(st, tol)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want), int((got - want).abs().max())
    return got


@pytest.mark.parametrize("tol", [-1, 0, 1, 350, 511, 512, 1023, 1024, 1025, 5000])
def test_k2_counts_equal_plain_at_tolerance_edges(dev, tol):
    """Pairs planted at ham == tol and tol + 1, nonzero pad bits, n not a
    multiple of 128."""
    packed, bounds = _planted_at(1000, tol, seed=tol + 7)
    st = hc.SearchState(packed, bounds, dev)
    got = _k2_equal(st, tol)
    if 0 <= tol <= 1023:  # every ham == tol pair counts, ham == tol + 1 does not
        dist = np.bitwise_count(packed[0::5][:199] ^ packed[1::5][:199]).sum(1)
        assert (dist == tol).all()
        assert int(got.sum()) >= 199


@pytest.mark.parametrize("n", [1, 2, 100, 127, 128, 129, 255, 256])
@pytest.mark.parametrize("tol", [0, 350, 1024])
def test_k2_small_and_single_tile(dev, n, tol):
    packed, bounds = _planted_at(n, tol, seed=n)
    _k2_equal(hc.SearchState(packed, bounds, dev), tol)


@pytest.mark.parametrize("tol", [0, 350, 1023, 1024])
@pytest.mark.parametrize("case", list(CASES))
def test_k2_window_mode_equals_plain(dev, case, tol):
    _k2_equal(hc.RefsState(*CASES[case](), dev), tol)


@pytest.mark.parametrize("tol", [350, 1024])
def test_k2_window_mode_planted_edges(dev, tol):
    """References at ham == tol and tol + 1 from candidates inside their
    windows, nonzero pad bits on both sides."""
    cands, _ = _planted_at(1500, tol, seed=3)
    rng = np.random.default_rng(4)
    idx = np.arange(0, 1500, 7)
    refs = np.stack([_flip_exactly(cands[i], rng, min(tol + (k % 2), 1024))
                     for k, i in enumerate(idx)])
    lo = np.maximum(idx - 200, 0)
    hi = np.minimum(idx + 150, 1500)
    st = hc.RefsState(refs, cands, lo, hi, dev)
    got = _k2_equal(st, tol)
    assert int(got.sum()) >= (len(idx) + 1) // 2


def test_k2_state_after_a_later_append(dev):
    """A zero-copy resident state whose pad rows a later ``append`` fills
    with copies of its own rows: the window, not zero pad data, keeps them
    out of the counts."""
    packed, bounds = _planted_at(1000, 350, seed=11)
    lib = IncrementalDeviceLibrary(dev, capacity=2048)
    lib.append(packed)
    n = lib.n
    st = lib.state(np.arange(n), np.full(n, n))
    assert st.packed.data_ptr() == lib.packed.data_ptr()
    before = _k2_equal(st, 350)
    lib.append(packed[n - n % hc.TILE :])  # copies of the last tile's rows
    assert st.packed.data_ptr() == lib.packed.data_ptr() and st.packed[n:].any()
    assert torch.equal(_k2_equal(st, 350), before)
    grown = lib.state(np.arange(lib.n), np.full(lib.n, lib.n))
    assert int(_k2_equal(grown, 350).sum()) >= int(before.sum()) + n % hc.TILE
