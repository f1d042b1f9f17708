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
from vid_dup_finder_lib_tpu.ops.golden import dct2_matrix, hash_bits_golden
from vid_dup_finder_lib_tpu.video_hash import VideoHash
from vid_dup_finder_lib_tpu_torch import convert
from tests.test_torch_hamming import LIBRARIES, _library
from tests.test_torch_hash import golden_corpus, separable_hash_fp32
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


# -- K1: the separable fp32 DCT ------------------------------------------------


def _cubes(n, seed):
    """Half uniform, half low-contrast (128 +/- 2) cubes."""
    rng = np.random.default_rng(seed)
    uni = rng.integers(0, 256, (n - n // 2, 16, 16, 16), dtype=np.uint8)
    low = (128 + rng.integers(-2, 3, (n // 2, 16, 16, 16))).astype(np.uint8)
    return np.concatenate([uni, low])


def _k1(dev, cubes_np, **kw):
    before = hk.hash_cubes.launches
    got = hk.hash_cubes(torch.from_numpy(cubes_np).to(dev), **kw)
    torch.cuda.synchronize()
    assert hk.hash_cubes.launches == before + (cubes_np.shape[0] > 0)
    assert got.dtype == torch.int32 and got.shape == (cubes_np.shape[0], 32)
    return got.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("batch", [0, 1, 17, 129, 4099])
def test_k1_batch_sizes_match_plain(dev, batch):
    """B = 0, 1, 17 (a device-preprocessing flush), odd and not a multiple
    of the kernel's cubes per block: <= 2 bits per hash from the plain
    version, bins 1000..1023 zero."""
    cubes = _cubes(batch, seed=batch)
    got = _k1(dev, cubes)
    want = hk.hash_cubes_plain(torch.from_numpy(cubes)).numpy().view(np.uint32)
    d = np.bitwise_count(got ^ want).sum(1)
    assert d.max(initial=0) <= 2, d.max()
    assert not (got[:, -1] >> np.uint32(8)).any()


def test_k1_equals_its_fp32_order(dev):
    """The kernel computes exactly the contraction order that the CPU
    tests hold to golden (tests/test_torch_hash.py separable_hash_fp32)."""
    cubes = golden_corpus()
    np.testing.assert_array_equal(_k1(dev, cubes), separable_hash_fp32(cubes))


def test_k1_orientation_on_kernel(dev):
    """cube[t, x, y] = frame_t[y, x] - 128 on the kernel: a cube hashes
    within 2 bits of golden and its x/y transpose far from it."""
    rng = np.random.default_rng(6)
    cube = rng.integers(0, 256, (1, 16, 16, 16), dtype=np.uint8)
    gold = hash_bits_golden(cube[0])
    ours = VideoHash.from_packed_u32(_k1(dev, cube)[0]).hash_bits()
    swapped = VideoHash.from_packed_u32(
        _k1(dev, np.ascontiguousarray(cube.transpose(0, 1, 3, 2)))[0]).hash_bits()
    assert (ours != gold).sum() <= 2
    assert (swapped != gold).sum() > 100


def test_k1_refuses_the_collapsed_operator(dev):
    cubes = torch.zeros((2, 16, 16, 16), dtype=torch.uint8, device=dev)
    d3 = hk._d3_on(dev)
    with pytest.raises(ValueError, match="dct="):
        hk.hash_cubes(cubes, d3=d3)


def test_k1_factor_override(dev):
    """dct= with the JAX package's DCT rows carried across gives the
    default factor's words; a factor of the wrong shape raises."""
    cubes = _cubes(64, seed=3)
    dct = convert.dct_rows_from_numpy(dct2_matrix(16, np.float64)[:10], device=dev)
    np.testing.assert_array_equal(_k1(dev, cubes, dct=dct), _k1(dev, cubes))
    with pytest.raises(ValueError, match="dct must be"):
        hk.hash_cubes(torch.from_numpy(cubes).to(dev), dct=dct.T.contiguous())


@pytest.mark.parametrize("value", [0, 77, 128, 255])
def test_k1_flat_cubes(dev, value):
    """Flat cubes: the AC signs are rounding noise for any fp32 order, but
    the kernel gives the same words on two launches, bin 0 equal to the
    golden model's, and all-zero words for 128."""
    cubes = np.full((3, 16, 16, 16), value, np.uint8)
    first = _k1(dev, cubes)
    np.testing.assert_array_equal(first, _k1(dev, cubes))
    assert ((first[:, 0] & 1) == int(hash_bits_golden(cubes[0])[0])).all()
    if value == 128:
        assert not first.any()


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


# -- K2 over slabs of row tiles, and the slabbed sweep ------------------------


def _sweep_state(mode, dev, n=1000, tol=350):
    if mode == "self":
        return hc.SearchState(*_planted_at(n, tol, seed=21), dev)
    return hc.RefsState(*CASES["windowed1000x333"](), dev)


@pytest.mark.parametrize("which", ["first", "inner", "last", "one_tile", "all", "empty"])
@pytest.mark.parametrize("mode", ["self", "window"])
def test_k2_row_tile_ranges_equal_plain(dev, mode, which):
    """One launch over row tiles [rt0, rt1): counts relative to the range,
    as wide as its widest band, equal to the plain version's range and to
    those rows of the whole state's counts."""
    st = _sweep_state(mode, dev)
    R = st.n_row_tiles
    rt0, rt1 = {"first": (0, 2), "inner": (1, R - 1), "last": (R - 2, R),
                "one_tile": (R // 2, R // 2 + 1), "all": (0, R), "empty": (1, 1)}[which]
    whole = _k2_equal(st, 350)
    before = hc.band_counts.launches
    got = hc.band_counts(st, 350, rt0, rt1)
    torch.cuda.synchronize()
    assert hc.band_counts.launches == before + (got.numel() > 0)
    want = hc.band_counts_plain(st, 350, rt0, rt1)
    assert got.shape == want.shape == (rt1 - rt0, int(st.n_ct[rt0:rt1].max(initial=0)))
    assert torch.equal(got, want)
    assert torch.equal(got, whole[rt0:rt1, : got.shape[1]])
    if which != "empty":
        assert int(got.sum()) > 0
    hits = hc.hit_tiles(st, got, rt0)
    all_hits = hc.hit_tiles(st, whole)
    keep = (all_hits[:, 0] >= rt0) & (all_hits[:, 0] < rt1)
    assert torch.equal(hits, all_hits[keep])


@pytest.mark.parametrize("budget", [None, 40, 7, 1])
@pytest.mark.parametrize("mode", ["self", "window"])
def test_slabbed_sweep_on_cuda_equals_one_slab(dev, mode, budget):
    """The sweep in slabs of row tiles: the one-slab sweep's pairs in the
    one-slab sweep's order, one K2 launch per slab with a band and one K3
    launch per slab with a hit, equal to the plain versions' pairs."""
    st = _sweep_state(mode, dev)
    sweep = hc.banded_adjacency_cuda if mode == "self" else hc.refs_adjacency_cuda
    plain = hc.banded_adjacency_plain if mode == "self" else hc.refs_adjacency_plain
    one = sweep(st, 350, counts_budget=10**12)
    slabs = hc.count_slabs(st, budget)
    assert len(slabs) == (1 if budget is None else st.n_row_tiles if budget == 1 else len(slabs))
    k2, k3 = hc.band_counts.launches, hc.band_pack.launches
    got = sweep(st, 350, counts_budget=budget)
    with_band = sum(bool(st.n_ct[a:b].any()) for a, b in slabs)
    assert hc.band_counts.launches == k2 + with_band
    assert 1 <= hc.band_pack.launches - k3 <= with_band
    want = plain(st, 350, counts_budget=budget)
    assert len(got[0]) > 0
    for other in (one, want):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])


def test_k2_at_a_row_tile_offset_past_2_to_24_rows(dev):
    """A resident library of 2^24 + 4096 rows whose only wide bands are its
    last 4096 rows': K2 over the last row tiles (rt0 past 131,072) against
    the plain version, and the slabbed sweep finds the pairs planted there,
    with row and column indices past 2^24."""
    n = 2**24 + 4096
    gen = torch.Generator(device=dev).manual_seed(5)
    lib = torch.randint(-2**31, 2**31 - 1, (n, 32), dtype=torch.int32, device=dev, generator=gen)
    planted = [(2**24 + 100, 2**24 + 101), (2**24 + 127, 2**24 + 128), (n - 300, n - 1)]
    for a, b in planted:
        lib[b] = lib[a]
    bounds = np.arange(1, n + 1, dtype=np.int64)  # no band ...
    bounds[2**24:] = np.minimum(np.arange(2**24, n) + 500, n)  # ... but for the last rows
    st = hc.SearchState(lib, bounds, lib.device, n=n)
    R = st.n_row_tiles
    assert R == 2**17 + 32 and st.slots >= 4
    for rt0, rt1 in ((R - 32, R - 24), (R - 1, R), (R - 40, R)):
        got = hc.band_counts(st, 0, rt0, rt1)
        torch.cuda.synchronize()
        assert torch.equal(got, hc.band_counts_plain(st, 0, rt0, rt1))
    for budget in (None, 2**17):
        i, j = hc.banded_adjacency_cuda(st, 0, counts_budget=budget)
        assert list(zip(i.tolist(), j.tolist())) == planted
    bi, bj = hb.banded_adjacency_band(None, None, 0, state=st)
    assert list(zip(bi.tolist(), bj.tolist())) == planted


def test_grow_raises_a_capacity_error(dev, monkeypatch):
    """A growth that the free device memory cannot hold beside the old
    buffer raises a ValueError naming rows and bytes, before allocating;
    the library stays as it was."""
    lib = IncrementalDeviceLibrary(dev, capacity=128)
    rows = np.random.default_rng(2).integers(0, 2**32, (100, 32), dtype=np.uint64).astype(np.uint32)
    lib.append(rows)
    real = torch.cuda.mem_get_info
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (1000, real(d)[1]))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: torch.cuda.memory_allocated(d))
    with pytest.raises(ValueError, match=r"cannot grow to 200 rows.*256 rows needs 32768 bytes"
                                         r".*16384.*1000 bytes free"):
        lib.append(rows)
    assert lib.n == 100 and lib.capacity == 128
    np.testing.assert_array_equal(lib.take_rows(np.arange(100)), rows)
    lib.append(rows[:28])  # an append that fits the capacity asks for nothing
    monkeypatch.undo()
    lib.append(rows)
    assert lib.n == 228 and lib.capacity == 256


# -- K4 on the tensor cores: counts and hit-tile words equal to the plain ----


def _k4_equal(st, tol, budget=None):
    """K4 over every range of ``band_ranges(st, budget)``: counts equal to
    the plain version's everywhere, words equal on every tile with a match;
    returns the counts, row tiles stacked."""
    out = []
    for rt0, rt1 in hb.band_ranges(st, budget):
        before = hb.band_sweep.launches
        counts, words = hb.band_sweep(st, tol, rt0, rt1)
        torch.cuda.synchronize()
        assert hb.band_sweep.launches == before + 1
        want_counts, want_words = hb.band_sweep_plain(st, tol, rt0, rt1)
        assert counts.dtype == torch.int32 and counts.shape == want_counts.shape
        assert torch.equal(counts, want_counts), int((counts - want_counts).abs().max())
        r, s = torch.nonzero(want_counts, as_tuple=True)
        idx = hb.tile_offsets(st, rt0, rt1)[r] + s
        assert torch.equal(words[idx], want_words[idx])
        out.append(counts)
    return torch.cat(out) if out else None


@pytest.mark.parametrize("budget", [1, 3, None])
@pytest.mark.parametrize("tol", [-1, 0, 350, 1024, 5000])
def test_k4_equals_plain_at_tolerance_edges(dev, tol, budget):
    """Pairs planted at ham == tol and tol + 1, nonzero pad bits, n not a
    multiple of 128, ranges of one row tile, of three band tiles, and one
    range."""
    packed, bounds = _planted_at(1000, tol, seed=tol + 7)
    st = hc.SearchState(packed, bounds, dev)
    got = _k4_equal(st, tol, budget)
    assert torch.equal(got, hc.band_counts_plain(st, tol))
    if 0 <= tol <= 1023:
        assert int(got.sum()) >= 199


@pytest.mark.parametrize("n", [1, 2, 100, 127, 128, 129, 256])
@pytest.mark.parametrize("tol", [0, 350, 1024])
def test_k4_small_and_single_tile(dev, n, tol):
    packed, bounds = _planted_at(n, tol, seed=n)
    _k4_equal(hc.SearchState(packed, bounds, dev), tol, 1)


def test_k4_state_after_a_later_append(dev):
    """A zero-copy resident state whose pad rows a later ``append`` fills:
    K4's counts and words do not change."""
    packed, bounds = _planted_at(1000, 350, seed=11)
    lib = IncrementalDeviceLibrary(dev, capacity=2048)
    lib.append(packed)
    n = lib.n
    st = lib.state(np.arange(n), np.full(n, n))
    assert st.packed.data_ptr() == lib.packed.data_ptr()
    before = _k4_equal(st, 350)
    lib.append(packed[n - n % hc.TILE :])
    assert st.packed.data_ptr() == lib.packed.data_ptr() and st.packed[n:].any()
    assert torch.equal(_k4_equal(st, 350), before)
    ki, kj = hb.banded_adjacency_band(None, None, 350, state=st)
    pi, pj = hc.banded_adjacency_plain(st, 350)
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kj, pj)


# -- K3 on the tensor cores: words equal to the plain version's ---------------


def _band_tiles(st):
    """Every band tile of the state as a row-major hit list, int32[H, 2]."""
    in_band = torch.arange(st.slots, device=st.device)[None, :] < st.n_ct_dev[:, None]
    return hc.hit_tiles(st, in_band)


def _k3_equal(st, hits, tol):
    before = hc.band_pack.launches
    got = hc.band_pack(st, hits, tol)
    torch.cuda.synchronize()
    assert hc.band_pack.launches == before + (hits.shape[0] > 0)
    want = hc.band_pack_plain(st, hits, tol)
    assert got.dtype == torch.int32 and got.shape == (hits.shape[0], 4, hc.TILE)
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("tol", [-1, 0, 1, 350, 511, 512, 1023, 1024, 1025, 5000])
def test_k3_words_equal_plain_at_tolerance_edges(dev, tol):
    """Every band tile (those without a match too) of a library with pairs
    planted at ham == tol and tol + 1, nonzero pad bits and a partial last
    row tile; the words hold exactly K2's counts."""
    packed, bounds = _planted_at(1000, tol, seed=tol + 7)
    st = hc.SearchState(packed, bounds, dev)
    hits = _band_tiles(st)
    assert hits.shape[0] == int(st.n_ct.sum()) > st.n_row_tiles
    words = _k3_equal(st, hits, tol)
    per_tile = np.bitwise_count(words.cpu().numpy().view(np.uint32)).reshape(len(hits), -1).sum(1)
    counts = hc.band_counts_plain(st, tol).cpu().numpy()
    rt, ct = hits.cpu().numpy().T
    np.testing.assert_array_equal(per_tile, counts[rt, ct - st.first_ct[rt]])
    if tol < 0:
        assert not words.any()


@pytest.mark.parametrize("n", [1, 2, 100, 127, 128, 129, 255, 256])
@pytest.mark.parametrize("tol", [0, 350, 1024])
def test_k3_small_and_single_tile(dev, n, tol):
    st = hc.SearchState(*_planted_at(n, tol, seed=n), dev)
    _k3_equal(st, _band_tiles(st), tol)


@pytest.mark.parametrize("tol", [0, 350, 1023, 1024])
@pytest.mark.parametrize("case", list(CASES))
def test_k3_window_mode_equals_plain(dev, case, tol):
    st = hc.RefsState(*CASES[case](), dev)
    _k3_equal(st, _band_tiles(st), tol)


@pytest.mark.parametrize("tol", [350, 1024])
def test_k3_window_mode_planted_edges(dev, tol):
    """References at ham == tol and tol + 1 inside their windows, a partial
    last reference tile whose pad rows must give no bits."""
    cands, _ = _planted_at(1500, tol, seed=3)
    rng = np.random.default_rng(4)
    idx = np.arange(0, 1500, 7)
    refs = np.stack([_flip_exactly(cands[i], rng, min(tol + (k % 2), 1024))
                     for k, i in enumerate(idx)])
    st = hc.RefsState(refs, cands, np.maximum(idx - 200, 0), np.minimum(idx + 150, 1500), dev)
    hits = _band_tiles(st)
    words = _k3_equal(st, hits, tol)
    assert np.bitwise_count(words.cpu().numpy().view(np.uint32)).sum() >= (len(idx) + 1) // 2
    # rows past the last reference: their bits of the last tile's words
    pad = st.n_rows % hc.TILE
    last = words[hits[:, 0] == st.n_row_tiles - 1].cpu().numpy().view(np.uint32)
    assert pad and not (last[:, pad // 32] >> np.uint32(pad % 32)).any()
    assert not last[:, pad // 32 + 1 :].any()


def _full_band_state(dev, n=5120):
    """A library in which every pair is in the band (40 row tiles, the
    first with 40 band tiles) and a third of the rows are near-copies."""
    rng = np.random.default_rng(n)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[1::3] = packed[0:-1:3]
    return hc.SearchState(packed, np.full(n, n), dev)


@pytest.mark.parametrize("kind", ["none", "one", "scattered", "reversed", "one_row_tile",
                                  "every_tile", "long_chunks"])
def test_k3_hit_lists(dev, kind):
    """Hit lists of every shape: empty; one tile; a few scattered tiles
    (chunks of one); a list in reverse order; one row tile's 40 tiles (a
    run longer than a chunk); every band tile (chunks that cross row
    tiles); and that list six times over, long enough for chunks of 32."""
    st = _full_band_state(dev)
    tiles = _band_tiles(st)
    assert tiles.shape[0] == 40 * 41 // 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    hits = {
        "none": tiles[:0],
        "one": tiles[77:78],
        "scattered": tiles[::97],
        "reversed": tiles.flip(0),
        "one_row_tile": tiles[:40],
        "every_tile": tiles,
        "long_chunks": tiles.repeat(6, 1),
    }[kind].clone()  # a slice may start off the 16-byte alignment the wrapper asks for
    if kind == "long_chunks":
        assert hc.pack_chunk(hits.shape[0], sms) == hc.PACK_CHUNK_MAX
    words = _k3_equal(st, hits, 350)
    if kind == "every_tile":
        ii, jj = hc.decode_words(st, hits, words)
        pi, pj = hc.banded_adjacency_plain(st, 350)
        np.testing.assert_array_equal(ii.cpu().numpy(), pi)
        np.testing.assert_array_equal(jj.cpu().numpy(), pj)
        assert len(pi) >= 5120 // 3


def test_k3_dense_clusters(dev):
    """4,096 hashes in 128 clusters of 32 at shared durations: the hit list
    of a library with many duplicates, and the pairs it decodes to."""
    rng = np.random.default_rng(9)
    seeds = rng.integers(0, 2**32, (128, 32), dtype=np.uint64).astype(np.uint32)
    packed = np.stack([_flip_exactly(seeds[c], rng, 40) for c in range(128) for _ in range(32)])
    durs = np.repeat(np.sort(rng.integers(30, 7200, 128)), 32)
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), side="right")
    st = hc.SearchState(packed, bounds, dev)
    hits = hc.hit_tiles(st, hc.band_counts(st, 350))
    assert hits.shape[0] >= 32
    words = _k3_equal(st, hits, 350)
    ii, _ = hc.decode_words(st, hits, words)
    assert ii.shape[0] >= 128 * 32 * 31 // 2


def test_k3_state_after_a_later_append(dev):
    """A zero-copy resident state whose pad rows a later ``append`` fills
    with copies of its own rows: the window keeps them out of the words."""
    packed, bounds = _planted_at(1000, 350, seed=11)
    lib = IncrementalDeviceLibrary(dev, capacity=2048)
    lib.append(packed)
    n = lib.n
    st = lib.state(np.arange(n), np.full(n, n))
    hits = _band_tiles(st)
    before = _k3_equal(st, hits, 350)
    lib.append(packed[n - n % hc.TILE :])
    assert st.packed.data_ptr() == lib.packed.data_ptr() and st.packed[n:].any()
    assert torch.equal(_k3_equal(st, hits, 350), before)


def test_k3_rejects_a_bad_hit_list(dev):
    st = hc.SearchState(*_planted_at(300, 350, seed=1), dev)
    with pytest.raises(ValueError):
        hc.band_pack(st, _band_tiles(st).long(), 350)
    with pytest.raises(ValueError):
        hc.band_pack(st, _band_tiles(st).T.contiguous(), 350)


# -- the multi-device layer on shards of one card ------------------------------


def _card_mesh(dev, shards):
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    return Mesh([dev] * shards)


@pytest.mark.parametrize("budget", [None, 64])
@pytest.mark.parametrize("shards", [4, 16])
def test_ring_on_shards_of_one_card_matches_the_single_card_sweep(dev, shards, budget):
    """The zero and all-ones hashes at block edges, bands across one block
    (4 shards) and two (16): K2 + K3 per (shard, step), from the host
    matrix and from a resident buffer, equal to the one-state sweep."""
    from tests.test_torch_parallel import guard_inputs
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda

    packed, bounds = guard_inputs()
    want = hc.banded_adjacency_cuda(hc.SearchState(packed, bounds, dev), 350)
    assert len(want[0]) > 0
    lib = IncrementalDeviceLibrary(dev, capacity=packed.shape[0])
    lib.append(packed)
    for source, n in ((packed, None), (lib.packed, lib.n)):
        k2, k3 = hc.band_counts.launches, hc.band_pack.launches
        got = ring_cuda.banded_adjacency_ring(source, bounds, 350, mesh=_card_mesh(dev, shards),
                                              counts_budget=budget, n=n)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        ph = ring_cuda.LAST_RING_PHASES
        assert ph["band_counts"] == hc.band_counts.launches - k2 >= shards
        assert ph["band_pack"] == hc.band_pack.launches - k3 >= 1
        assert ph["k_max"] == (1 if shards == 4 else 2) and ph["rotated_bytes"] > 0


def test_refs_sharded_on_shards_of_one_card(dev):
    """tests/test_refs_sharded.py's problem over four shards: candidates
    uploaded, and resident (each shard then uses the buffer as it is)."""
    from tests.test_refs_windowed import _refs_problem
    from vid_dup_finder_lib_tpu_torch.parallel.refs_sharded import refs_adjacency_sharded

    cands, refs, lo, hi = _refs_problem(np.random.default_rng(11))
    want = hc.refs_adjacency_cuda(hc.RefsState(refs, cands, lo, hi, dev), 300)
    assert len(want[0]) > 300
    resident = hc._tiled(cands, dev)
    for kw in (dict(cands_packed=cands), dict(cands_dev=resident, n_cands=cands.shape[0])):
        k2 = hc.band_counts.launches
        got = refs_adjacency_sharded(refs, lo, hi, 300, mesh=_card_mesh(dev, 4), **kw)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        # 333 references in shards of 128 rows: three shards hold some
        assert hc.band_counts.launches - k2 == 3


def test_sharded_hash_on_shards_of_one_card(dev):
    """4,099 cubes over four shards: one K1 launch each, bit-equal to one
    launch over the whole batch; fewer cubes than shards launch fewer."""
    from vid_dup_finder_lib_tpu_torch.parallel import sharded_hash_batch

    cubes = _cubes(4099, seed=8)
    single = hk.hash_cubes(torch.from_numpy(cubes).to(dev)).cpu().numpy().view(np.uint32)
    for batch, launched in ((cubes, 4), (cubes[:3], 3)):
        before = hk.hash_cubes.launches
        got = sharded_hash_batch(_card_mesh(dev, 4), torch.from_numpy(batch).to(dev))
        assert hk.hash_cubes.launches - before == launched
        assert np.array_equal(got, single[: batch.shape[0]])


def test_ring_candidate_scan_on_shards_of_one_card(dev):
    from tests.test_torch_parallel import scan_reference
    from vid_dup_finder_lib_tpu_torch.parallel import ring_candidate_scan

    rng = np.random.default_rng(9)
    n = 1500
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    packed[1::7] = packed[::7][: len(packed[1::7])]
    durs = np.sort(rng.integers(50, 400, n))
    got = ring_candidate_scan(_card_mesh(dev, 4), packed, durs, 470)
    for a, b in zip(got, scan_reference(packed, durs, 470)):
        assert np.array_equal(a, b)


# -- the multi-device layer over distinct cards ---------------------------------


def _cards(dev):
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs 2 cards, this host has {cards}")
    return [torch.device("cuda", i) for i in range(min(4, cards))]


@pytest.mark.parametrize("layout", ["distinct", "interleaved"])
def test_ring_over_distinct_cards_matches_the_single_card_sweep(dev, layout):
    """Each card's shards swept from a thread of its own, blocks copied
    between cards: every card once, or two shards on each card in
    alternation (8 shards, bands across up to two blocks)."""
    from tests.test_torch_parallel import guard_inputs
    from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh

    cards = _cards(dev)
    mesh = Mesh(cards if layout == "distinct" else cards * (8 // len(cards)))
    packed, bounds = guard_inputs()
    want = hc.banded_adjacency_cuda(hc.SearchState(packed, bounds, dev), 350)
    for budget in (None, 64):
        k2 = hc.band_counts.launches
        got = ring_cuda.banded_adjacency_ring(packed, bounds, 350, mesh=mesh, counts_budget=budget)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        ph = ring_cuda.LAST_RING_PHASES
        assert ph["band_counts"] == hc.band_counts.launches - k2 >= mesh.size
        assert ph["rotated_bytes"] > 0


def test_refs_sharded_hash_and_scan_over_distinct_cards(dev):
    """The references split over every card (candidates uploaded to each,
    or copied from a resident buffer), the sharded hash and the scan."""
    from tests.test_refs_windowed import _refs_problem
    from tests.test_torch_parallel import scan_reference
    from vid_dup_finder_lib_tpu_torch.parallel import ring_candidate_scan, sharded_hash_batch
    from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh
    from vid_dup_finder_lib_tpu_torch.parallel.refs_sharded import refs_adjacency_sharded

    mesh = Mesh(_cards(dev))
    cands, refs, lo, hi = _refs_problem(np.random.default_rng(11))
    want = hc.refs_adjacency_cuda(hc.RefsState(refs, cands, lo, hi, dev), 300)
    resident = hc._tiled(cands, mesh[0])
    for kw in (dict(cands_packed=cands), dict(cands_dev=resident, n_cands=cands.shape[0])):
        got = refs_adjacency_sharded(refs, lo, hi, 300, mesh=mesh, **kw)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    cubes = _cubes(4099, seed=8)
    single = hk.hash_cubes(torch.from_numpy(cubes).to(dev)).cpu().numpy().view(np.uint32)
    assert np.array_equal(sharded_hash_batch(mesh, cubes), single)
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 2**32, (1500, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    packed[1::7] = packed[::7][: len(packed[1::7])]
    durs = np.sort(rng.integers(50, 400, 1500))
    for a, b in zip(ring_candidate_scan(mesh, packed, durs, 470), scan_reference(packed, durs, 470)):
        assert np.array_equal(a, b)
