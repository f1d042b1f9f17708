"""The port's banded adjacency (``vid_dup_finder_lib_tpu_torch.ops``)
against the JAX package's Pallas sweep and its NumPy host sweep.

The same NumPy-made libraries go through both packages; pairs must be
identical (exact integer semantics, no tolerance).  The plain versions of
the two CUDA kernels are also held, tile by tile and word by word, to what
the host pairs imply.
"""

import numpy as np
import pytest
import torch

from tests.test_windowed import _random_library
from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
    PallasSearchState,
    banded_adjacency_pallas,
)
from vid_dup_finder_lib_tpu_torch import convert
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops.hamming import banded_adjacency

CPU = torch.device("cpu")


def _flip(h, rng, count):
    h = h.copy()
    for b in rng.choice(1000, count, replace=False):
        h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return h


def _dense(rng):
    """The dense 300-hash cluster of test_sweep_schemes: one seed, 40 flips
    each, a full band."""
    n = 300
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    seed[-1] &= np.uint32(0xFF)
    packed = np.stack([_flip(seed, rng, 40) for _ in range(n)])
    return packed, np.full(n, n, dtype=np.int64)


def _pad_bits(rng):
    """Random nonzero pad bits (bits 1000..1023) in every row."""
    packed, bounds = _random_library(600, rng)
    packed[:, -1] |= rng.integers(1, 2**24, 600, dtype=np.uint64).astype(
        np.uint32
    ) << np.uint32(8)
    return packed, bounds


LIBRARIES = {
    "random900": lambda rng: _random_library(900, rng),
    "dense300": _dense,
    "pad_bits": _pad_bits,
    "empty": lambda rng: (np.zeros((0, 32), np.uint32), np.zeros(0, np.int64)),
    "single": lambda rng: _random_library(1, rng),
    "ragged130": lambda rng: _random_library(130, rng),  # one tile + 2 rows
}


def _library(name):
    return LIBRARIES[name](np.random.default_rng(sum(map(ord, name))))


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", list(LIBRARIES))
def test_pairs_match_jax_host_and_pallas(name, tol):
    packed, bounds = _library(name)
    hi, hj = banded_adjacency_host(packed, bounds, tol)
    ti, tj = banded_adjacency(packed, bounds, tol, device=CPU)
    assert ti.dtype == np.int64 and tj.dtype == np.int64
    np.testing.assert_array_equal(ti, hi)
    np.testing.assert_array_equal(tj, hj)
    if len(packed) > 0:
        pi, pj = banded_adjacency_pallas(packed, bounds, tol, interpret=True)
        np.testing.assert_array_equal(ti, pi)
        np.testing.assert_array_equal(tj, pj)
    if tol == 1100:  # every in-band pair matches
        n = len(packed)
        b = np.minimum(bounds, n)
        assert len(ti) == int(np.maximum(b - np.arange(1, n + 1), 0).sum())


def _expected_tiles(state, hi, hj):
    """Per-tile counts and transposed packed words implied by host pairs."""
    T = hc.TILE
    counts = np.zeros((state.n_row_tiles, state.slots), np.int64)
    rt, ct = hi // T, hj // T
    np.add.at(counts, (rt, ct - state.first_ct[rt]), 1)
    hits = np.argwhere(counts > 0)
    hit_ct = state.first_ct[hits[:, 0]] + hits[:, 1]
    index = {(int(r), int(c)): h for h, (r, c) in enumerate(zip(hits[:, 0], hit_ct))}
    words = np.zeros((len(hits), T // 32, T), np.uint32)
    for i, j in zip(hi.tolist(), hj.tolist()):
        h = index[(i // T, j // T)]
        words[h, (i % T) // 32, j % T] |= np.uint32(1) << np.uint32(i % 32)
    return counts, np.stack([hits[:, 0], hit_ct], 1), words


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", ["random900", "dense300", "pad_bits", "ragged130"])
def test_plain_counts_and_words_match_host_pairs(name, tol):
    packed, bounds = _library(name)
    hi, hj = banded_adjacency_host(packed, bounds, tol)
    state = hc.SearchState(packed, bounds, CPU)
    counts, hit_tiles, words = _expected_tiles(state, hi, hj)

    got_counts = hc.band_counts_plain(state, tol)
    assert got_counts.dtype == torch.int32
    np.testing.assert_array_equal(got_counts.numpy(), counts)

    hits = hc.hit_tiles(state, got_counts)
    np.testing.assert_array_equal(hits.numpy(), hit_tiles)
    got_words = hc.band_pack_plain(state, hits, tol)
    assert got_words.shape == (len(hit_tiles), hc.TILE // 32, hc.TILE)
    np.testing.assert_array_equal(got_words.numpy().view(np.uint32), words)


def test_state_layout_pads_and_clamps():
    packed, bounds = _random_library(300, np.random.default_rng(3))
    bounds = bounds.copy()
    bounds[0] = 10**6  # beyond n: clamped
    st = convert.search_state_from_numpy(packed, bounds, device=CPU)
    assert st.n == 300 and st.n_pad == 384 and st.n_row_tiles == 3
    assert st.packed.dtype == torch.int32 and st.packed.shape == (384, 32)
    np.testing.assert_array_equal(st.packed[:300].numpy().view(np.uint32), packed)
    assert not st.packed[300:].any()
    b = st.bounds.numpy()
    assert b[0] == 300 and (b[300:] == -1).all()
    np.testing.assert_array_equal(b[1:300], np.minimum(bounds[1:], 300))
    # every candidate pair lies in its row tile's band of column tiles
    T = hc.TILE
    for i in range(300):
        if b[i] > i + 1:
            rt = i // T
            lo, hi = st.first_ct[rt], st.first_ct[rt] + st.n_ct[rt]
            assert lo <= (i + 1) // T and (b[i] - 1) // T < hi
    assert st.comparisons() == int(np.maximum(b[:300] - np.arange(1, 301), 0).sum())


@pytest.mark.parametrize("n", [1, 900])
def test_pm1_to_packed_round_trips_pallas_state(n):
    packed, bounds = _random_library(n, np.random.default_rng(n))
    pm1 = np.asarray(PallasSearchState(packed, bounds).pm1)
    back = convert.pm1_to_packed(pm1)
    assert back.dtype == np.uint32 and back.shape[0] == pm1.shape[0]
    np.testing.assert_array_equal(back[:n], packed)
    assert not back[n:].any()  # pad rows are all -1: zero words


def test_pm1_to_packed_rejects_wrong_width():
    with pytest.raises(ValueError):
        convert.pm1_to_packed(np.ones((4, 1000), np.int8))


def test_state_rejects_bad_shapes():
    with pytest.raises(ValueError):
        hc.SearchState(np.zeros((4, 31), np.uint32), np.zeros(4), CPU)
    with pytest.raises(ValueError):
        hc.SearchState(np.zeros((4, 32), np.uint32), np.zeros(3), CPU)


def test_unknown_backend_raises():
    packed, bounds = _random_library(10, np.random.default_rng(0))
    with pytest.raises(ValueError):
        banded_adjacency(packed, bounds, 350, backend="pallas", device=CPU)


def test_host_backend_is_the_jax_host_sweep():
    packed, bounds = _random_library(500, np.random.default_rng(8))
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    ti, tj = banded_adjacency(packed, bounds, 350, backend="host")
    np.testing.assert_array_equal(ti, hi)
    np.testing.assert_array_equal(tj, hj)
