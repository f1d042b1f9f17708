"""The port's whole-band sweep (K4, ``backend="band"``) against the JAX
package's ``banded_adjacency_band`` (Pallas, interpret mode on the CPU), its
NumPy host sweep, and the port's own two-phase sweep.

Inputs are made with NumPy from a seed; pairs and groups are held exactly
(integer semantics, no tolerance).  On the CPU the wrapper runs the
kernel's plain version, ``band_sweep_plain``.
"""

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_hamming import LIBRARIES, _library
from tests.test_torch_search import _planted_library, jax_hashes, same_groups
from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
from vid_dup_finder_lib_tpu.ops.hamming_band import (
    banded_adjacency_band as jax_banded_adjacency_band,
)
from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops.hamming import banded_adjacency

CPU = torch.device("cpu")


def _parallel_library():
    """The inputs of tests/test_parallel.py::test_band_kernel_matches_host_interpret."""
    rng = np.random.default_rng(5)
    n = 600
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    durs = np.sort(rng.integers(50, 200, n))
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), side="right")
    return packed, bounds


@pytest.mark.parametrize("tol", [350, 480])
def test_band_matches_jax_band_interpret(tol):
    packed, bounds = _parallel_library()
    ji, jj = jax_banded_adjacency_band(packed, bounds, tol, interpret=True)
    ti, tj = banded_adjacency(packed, bounds, tol, backend="band", device=CPU)
    assert ti.dtype == np.int64 and tj.dtype == np.int64
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    hi, hj = banded_adjacency_host(packed, bounds, tol)
    np.testing.assert_array_equal(ti, hi)
    np.testing.assert_array_equal(tj, hj)


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", list(LIBRARIES))
def test_band_matches_host_and_two_phase(name, tol):
    packed, bounds = _library(name)
    ti, tj = banded_adjacency(packed, bounds, tol, backend="band", device=CPU)
    di, dj = banded_adjacency(packed, bounds, tol, backend="device", device=CPU)
    np.testing.assert_array_equal(ti, di)
    np.testing.assert_array_equal(tj, dj)
    if len(packed):
        hi, hj = banded_adjacency_host(packed, bounds, tol)
        np.testing.assert_array_equal(ti, hi)
        np.testing.assert_array_equal(tj, hj)


@pytest.mark.parametrize("budget", [1, 3, 7])
def test_ranges_concatenate_to_the_same_pairs(monkeypatch, budget):
    packed, bounds = _library("random900")
    want = banded_adjacency_host(packed, bounds, 1100)
    state = hc.SearchState(packed, bounds, CPU)
    assert len(hb.band_ranges(state, budget)) > 1
    monkeypatch.setattr(hb, "WORD_BUDGET_TILES", budget)
    got = hb.banded_adjacency_band(None, None, 1100, state=state)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("budget", [1, 2, 5, 1 << 18])
def test_ranges_partition_the_row_tiles(budget):
    state = hc.SearchState(*_library("random900"), CPU)
    ranges = hb.band_ranges(state, budget)
    assert ranges[0][0] == 0 and ranges[-1][1] == state.n_row_tiles
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for rt0, rt1 in ranges:
        assert rt1 > rt0
        assert rt1 - rt0 == 1 or state.n_ct[rt0:rt1].sum() <= budget
    assert hb.band_ranges(hc.SearchState(*_library("empty"), CPU)) == []


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", ["random900", "dense300", "pad_bits", "ragged130"])
def test_sweep_plain_matches_two_phase_plain(name, tol):
    """K4's plain counts are phase A's rows; its words on every hit tile
    are phase B's words of that tile."""
    state = hc.SearchState(*_library(name), CPU)
    counts_a = hc.band_counts_plain(state, tol)
    for rt0, rt1 in hb.band_ranges(state, 2):
        counts, words = hb.band_sweep_plain(state, tol, rt0, rt1)
        assert counts.dtype == torch.int32 and words.dtype == torch.int32
        assert counts.shape == (rt1 - rt0, state.slots)
        assert words.shape == (state.n_ct[rt0:rt1].sum(), hc.TILE // 32, hc.TILE)
        assert torch.equal(counts, counts_a[rt0:rt1])
        r, s = torch.nonzero(counts, as_tuple=True)
        hits = torch.stack([r + rt0, state.first_ct_dev[r + rt0] + s], 1).to(torch.int32)
        want = hc.band_pack_plain(state, hits, tol)
        assert torch.equal(words[hb.tile_offsets(state, rt0, rt1)[r] + s], want)
        # tiles without a match hold no bits
        zero = torch.ones(words.shape[0], dtype=torch.bool)
        zero[hb.tile_offsets(state, rt0, rt1)[r] + s] = False
        assert not words[zero].any()


def test_sweep_rejects_a_bad_range():
    state = hc.SearchState(*_library("random900"), CPU)
    with pytest.raises(ValueError):
        hb.band_sweep(state, 350, 3, state.n_row_tiles + 1)
    with pytest.raises(ValueError):
        hb.band_sweep(state, 350, 2, 1)


@pytest.fixture(scope="module")
def library():
    return _planted_library(900, 12, seed=21)


@pytest.mark.parametrize("tolerance", [0.0, 0.35, 0.5])
def test_search_band_matches_jax_and_other_backends(library, tolerance):
    hashes, planted, _ = library
    ours = tvdf.search(hashes, tolerance, backend="band", device=CPU)
    assert same_groups(ours, jvdf.search(jax_hashes(hashes), tolerance, backend="band"))
    for backend in ("device", "host"):
        assert ours == tvdf.search(hashes, tolerance, backend=backend, device=CPU)
    if tolerance == 0.35:
        assert {frozenset(g.contained_paths()) for g in ours} == planted


# -- K4's epilogue: wgmma's D fragment -> K3's word layout ------------------


def _every_fourth(x: int, m: int) -> int:
    """band_sweep.cu every_fourth: bits m, m + 4, ..., m + 28 -> bits 0..7."""
    x = (x >> m) & 0x11111111
    x = (x | (x >> 3)) & 0x03030303
    x = (x | (x >> 6)) & 0x000F000F
    return (x | (x >> 12)) & 0xFF


def k4_epilogue_words(pred: np.ndarray) -> np.ndarray:
    """bool[128 rows, 128 columns] -> uint32[4, 128], the way
    ``band_sweep_kernel`` builds a tile's words: warp q of warpgroup g holds
    rows 64g + 16q + lane // 4 (+8 for fragment entries e >= 2), columns
    8j + 2 (lane % 4) (+1 for odd e); four ballots per j; lane L keeps those
    of j = L // 2 and writes the 16-bit halves of columns 8j + 2m + L % 2
    into half q % 2 of word 2g + q // 2."""
    words = np.zeros((4, 128), np.uint32)
    for g in range(2):
        for q in range(4):
            row0 = 64 * g + 16 * q
            ballot = np.zeros((16, 4), np.int64)
            for lane in range(32):
                for j in range(16):
                    for e in range(4):
                        r = row0 + lane // 4 + 8 * (e >> 1)
                        c = 8 * j + 2 * (lane % 4) + (e & 1)
                        ballot[j, e] |= int(pred[r, c]) << lane
            for lane in range(32):
                jl, e1 = lane // 2, lane % 2
                top, bot = int(ballot[jl, e1]), int(ballot[jl, 2 + e1])
                for m in range(4):
                    c = 8 * jl + 2 * m + e1
                    half = _every_fourth(top, m) | (_every_fourth(bot, m) << 8)
                    words[2 * g + q // 2, c] |= np.uint32(half << (16 * (q % 2)))
    return words


@pytest.mark.parametrize("kind", ["random", "sparse", "all", "diagonal", "one_row", "one_column"])
def test_k4_fragment_to_word_mapping(kind):
    """The index arithmetic of K4's word epilogue, rehearsed in NumPy, gives
    exactly ``pack_words`` of the same predicate tile (K3's layout: word
    [w, c] holds rows 32w .. 32w + 31 of column c, bit b = row 32w + b)."""
    rng = np.random.default_rng(len(kind))
    pred = {
        "random": rng.random((128, 128)) < 0.5,
        "sparse": rng.random((128, 128)) < 0.01,
        "all": np.ones((128, 128), bool),
        "diagonal": np.eye(128, dtype=bool),
        "one_row": np.broadcast_to(np.arange(128)[:, None] == 77, (128, 128)),
        "one_column": np.broadcast_to(np.arange(128)[None, :] == 45, (128, 128)),
    }[kind]
    want = hc.pack_words(torch.from_numpy(np.ascontiguousarray(pred)).view(4, 32, 128))
    got = k4_epilogue_words(pred)
    np.testing.assert_array_equal(got.view(np.int32), want.numpy())
