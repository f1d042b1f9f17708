"""The port's banded adjacency (``vid_dup_finder_lib_tpu_torch.ops``)
against the JAX package's Pallas sweep and its NumPy host sweep.

The same NumPy-made libraries go through both packages; pairs must be
identical (exact integer semantics, no tolerance).  The plain versions of
the two CUDA kernels are also held, tile by tile and word by word, to what
the host pairs imply.  The sweep walks slabs of row tiles under a budget of
count cells; budgets that give one, two and many slabs must give the same
pairs in the same order.
"""

import functools

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
    ti, tj = banded_adjacency(packed, bounds, tol, backend="device", device=CPU)
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


# -- band_pack: any tile list, and how the kernel's blocks walk it ------------


def _all_band_tiles(state):
    in_band = torch.arange(state.slots)[None, :] < state.n_ct_dev[:, None]
    return hc.hit_tiles(state, in_band)


@pytest.mark.parametrize("mode", ["self", "window"])
@pytest.mark.parametrize("name", ["random900", "dense300", "pad_bits", "ragged130"])
def test_plain_pack_takes_any_tile_list(name, mode):
    """``band_pack`` is asked for every band tile, not only those with a
    match, in reverse order and with repeats: a tile without a match gets
    zero words, every tile's words hold exactly its count of pairs, and a
    tile's words do not depend on its place in the list."""
    packed, bounds = _library(name)
    if mode == "self":
        state = hc.SearchState(packed, bounds, CPU)
    else:
        idx = np.arange(0, len(packed), 3)
        state = hc.RefsState(packed[idx], packed, np.maximum(idx - 37, 0), bounds[idx], CPU)
    counts = hc.band_counts_plain(state, 350)
    tiles = _all_band_tiles(state)
    assert tiles.shape[0] == int(state.n_ct.sum())
    words = hc.band_pack(state, tiles, 350)
    per_tile = np.bitwise_count(words.numpy().view(np.uint32)).reshape(len(tiles), -1).sum(1)
    rt, ct = tiles.numpy().T
    np.testing.assert_array_equal(per_tile, counts.numpy()[rt, ct - state.first_ct[rt]])
    if name in ("random900", "pad_bits"):  # wide bands: some tiles hold no match
        assert (per_tile == 0).any()
    again = hc.band_pack(state, torch.cat([tiles.flip(0), tiles[:3]]), 350)
    assert torch.equal(again[: len(tiles)].flip(0), words)
    assert torch.equal(again[len(tiles) :], words[:3])
    hits = hc.hit_tiles(state, counts)
    keep = torch.from_numpy(per_tile > 0)
    assert torch.equal(hits, tiles[keep])
    assert torch.equal(hc.band_pack(state, hits, 350), words[keep])


@pytest.mark.parametrize("n_hits", [0, 1, 131, 132, 133, 199, 512, 4092, 4093, 65_536, 10**9])
@pytest.mark.parametrize("n_sms", [1, 132])
def test_pack_chunk(n_hits, n_sms):
    """Hits per block: the smallest chunk that gives at most one block per
    multiprocessor, between 1 and ``PACK_CHUNK_MAX``."""
    chunk = hc.pack_chunk(n_hits, n_sms)
    fits = [c for c in range(1, hc.PACK_CHUNK_MAX + 1) if -(-n_hits // c) <= n_sms]
    assert chunk == (fits[0] if fits else hc.PACK_CHUNK_MAX)


def k3_walk(hits: np.ndarray, chunk: int) -> list[list[tuple[int, bool]]]:
    """``band_pack_kernel``'s walk over a hit list, per block: (hit index,
    whether the block expands the hit's row tile before its products)."""
    blocks = []
    for h0 in range(0, len(hits), chunk):
        rt, block = -1, []
        for h in range(h0, min(h0 + chunk, len(hits))):
            block.append((h, int(hits[h, 0]) != rt))
            rt = int(hits[h, 0])
        blocks.append(block)
    return blocks


_WALK_LISTS = {
    "empty": np.zeros((0, 2), np.int64),
    "one": np.array([[3, 4]]),
    "one_row_tile": np.stack([np.full(100, 7), 7 + np.arange(100)], 1),
    "diagonal": np.stack([np.arange(50), np.arange(50)], 1),
    "runs": np.stack([np.repeat(np.arange(9), [1, 40, 2, 33, 32, 1, 64, 3, 5]), np.arange(181)], 1),
}


@pytest.mark.parametrize("chunk", [1, 4, 32])
@pytest.mark.parametrize("name", list(_WALK_LISTS))
def test_k3_walk_against_brute_force_runs(name, chunk):
    """Every hit is taken once and in order, by block ``h // chunk``; a row
    tile is expanded exactly at the start of each run of equal row tiles
    within a block (runs found here by brute force over all hit pairs), so
    a run longer than the chunk is expanded once per block it spans."""
    hits = _WALK_LISTS[name]
    blocks = k3_walk(hits, chunk)
    flat = [h for block in blocks for h, _ in block]
    assert flat == list(range(len(hits)))
    assert all(len(b) <= chunk and b for b in blocks)
    assert len(blocks) == -(-len(hits) // chunk)
    for b, block in enumerate(blocks):
        for h, expands in block:
            assert h // chunk == b
            run = [g for g, _ in block if g <= h and all(
                hits[k, 0] == hits[h, 0] for k in range(g, h + 1))]
            assert expands == (run == [h])
    expansions = sum(e for block in blocks for _, e in block)
    starts = sum(1 for h in range(len(hits)) if h % chunk == 0 or hits[h, 0] != hits[h - 1, 0])
    assert expansions == starts


# -- the slabbed sweep: counts of a slab of row tiles at a time ---------------


def _seam_library():
    """1,000 random hashes, all in one duration window, with a cluster of
    four near copies on rows 126..129 (across the seam of row tiles 0 and 1),
    a pair inside row tile 3 and nothing else within 350 bits."""
    rng = np.random.default_rng(41)
    packed = rng.integers(0, 2**32, (1000, 32), dtype=np.uint64).astype(np.uint32)
    for k in (127, 128, 129):
        packed[k] = _flip(packed[126], rng, 60)
    packed[400] = _flip(packed[390], rng, 60)
    return packed, np.full(1000, 1000, dtype=np.int64)


SLAB_LIBRARIES = {**LIBRARIES, "seam": lambda rng: _seam_library()}
SLAB_NAMES = ["random900", "dense300", "pad_bits", "ragged130", "seam"]


def budget_for(state, n_slabs):
    """The largest counts budget that cuts ``state`` into at least
    ``n_slabs`` slabs."""
    for budget in range(state.n_row_tiles * max(state.slots, 1), 0, -1):
        if len(hc.count_slabs(state, budget)) >= n_slabs:
            return budget
    raise AssertionError(f"no budget gives {n_slabs} slabs")


@pytest.mark.parametrize("budget", [None, 10**12, 40, 7, 1])
@pytest.mark.parametrize("name", SLAB_NAMES + ["empty", "single"])
def test_count_slabs_cover_the_state_within_the_budget(name, budget):
    """Consecutive slabs from row tile 0 to the last; each fits the budget
    or is a single row tile, and could not have taken one row tile more."""
    packed, bounds = SLAB_LIBRARIES[name](np.random.default_rng(5))
    state = hc.SearchState(packed, bounds, CPU)
    slabs = hc.count_slabs(state, budget)
    cells = lambda a, b: (b - a) * int(state.n_ct[a:b].max(initial=0))
    cap = hc.COUNTS_BUDGET if budget is None else budget
    assert [a for a, _ in slabs] == [0] * bool(slabs) + [b for _, b in slabs[:-1]]
    assert (slabs[-1][1] if slabs else 0) == state.n_row_tiles
    for a, b in slabs:
        assert b > a and (cells(a, b) <= cap or b == a + 1)
        assert b == state.n_row_tiles or cells(a, b + 1) > cap
    if budget in (None, 10**12):
        assert len(slabs) == min(1, state.n_row_tiles)
    if budget == 1:
        assert slabs == [(r, r + 1) for r in range(state.n_row_tiles)]


@functools.lru_cache(maxsize=None)
def _slab_references(name):
    """What every slabbed sweep of library ``name`` must give: the
    one-slab sweep's pairs at 350 and 1100 bits, which equal the host
    sweep's and, at 350, the JAX package's Pallas sweep's."""
    packed, bounds = SLAB_LIBRARIES[name](np.random.default_rng(sum(map(ord, name))))
    state = hc.SearchState(packed, bounds, CPU)
    one = {tol: hc.banded_adjacency_cuda(state, tol, counts_budget=10**12) for tol in (350, 1100)}
    for tol, pairs in one.items():
        host = banded_adjacency_host(packed, bounds, tol)
        np.testing.assert_array_equal(pairs[0], host[0])
        np.testing.assert_array_equal(pairs[1], host[1])
    pi, pj = banded_adjacency_pallas(packed, bounds, 350, interpret=True)
    np.testing.assert_array_equal(one[350][0], pi)
    np.testing.assert_array_equal(one[350][1], pj)
    return state, one


@pytest.mark.parametrize("slabs", [1, 2, "many", "one_row_tile_each"])
@pytest.mark.parametrize("name", SLAB_NAMES)
def test_slabbed_sweep_matches_one_slab_host_and_pallas(name, slabs):
    state, one = _slab_references(name)
    R = state.n_row_tiles
    if slabs == "one_row_tile_each":
        budget = 1
    else:
        budget = budget_for(state, min(3, R) if slabs == "many" else slabs)
    cut = hc.count_slabs(state, budget)
    assert len(cut) >= {1: 1, 2: 2, "many": min(3, R), "one_row_tile_each": R}[slabs]
    assert len(cut) == slabs or slabs not in (1, 2)
    assert len(cut) == R or slabs != "one_row_tile_each"
    # on a CPU state banded_adjacency_cuda runs the plain versions; the
    # all-pairs tolerance only where it is cheap
    for tol, want in one.items():
        if tol == 1100 and name not in ("dense300", "ragged130", "seam"):
            continue
        got = hc.banded_adjacency_cuda(state, tol, counts_budget=budget)
        assert got[0].dtype == np.int64 and got[1].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_slab_seam_inside_a_cluster_and_slabs_without_a_hit():
    """One row tile per slab: the cluster on rows 126..129 gives pairs in
    slabs 0 and 1 (tiles (0, 0), (0, 1), (1, 1)), the pair (390, 400) in
    slab 3, and the other slabs find nothing."""
    packed, bounds = _seam_library()
    state = hc.SearchState(packed, bounds, CPU)
    want = [(126, 127), (126, 128), (126, 129), (127, 128), (127, 129), (128, 129), (390, 400)]
    per_slab = []
    for rt0, rt1 in hc.count_slabs(state, 1):
        counts = hc.band_counts(state, 350, rt0, rt1)
        assert counts.shape == (1, int(state.n_ct[rt0]))
        per_slab.append(hc.hit_tiles(state, counts, rt0).tolist())
    assert per_slab == [[[0, 0], [0, 1]], [[1, 1]], [], [[3, 3]], [], [], [], []]
    for budget in (1, 9, None):
        i, j = hc.banded_adjacency_cuda(state, 350, counts_budget=budget)
        assert list(zip(i.tolist(), j.tolist())) == want


@pytest.mark.parametrize("name", ["random900", "dense300", "ragged130", "seam"])
def test_plain_counts_of_a_range_are_rows_of_the_whole(name):
    """``band_counts_plain(state, tol, rt0, rt1)``: the rows rt0..rt1-1 of
    the whole state's counts, as wide as the range's widest band (the
    columns past it are zero in the whole), and ``hit_tiles`` with ``rt0``
    names the same tiles."""
    packed, bounds = SLAB_LIBRARIES[name](np.random.default_rng(sum(map(ord, name))))
    state = hc.SearchState(packed, bounds, CPU)
    R = state.n_row_tiles
    whole = hc.band_counts_plain(state, 350)
    assert whole.shape == (R, state.slots)
    all_hits = hc.hit_tiles(state, whole)
    for rt0, rt1 in {(0, R), (0, 1), (R - 1, R), (1, R), (R // 2, R // 2 + 1), (1, 1), (R, R)}:
        if rt0 > rt1 or rt1 > R:
            continue
        part = hc.band_counts_plain(state, 350, rt0, rt1)
        slots = int(state.n_ct[rt0:rt1].max(initial=0))
        assert part.shape == (rt1 - rt0, slots) and part.dtype == torch.int32
        assert torch.equal(part, whole[rt0:rt1, :slots])
        assert not whole[rt0:rt1, slots:].any()
        assert torch.equal(hc.band_counts(state, 350, rt0, rt1), part)
        keep = (all_hits[:, 0] >= rt0) & (all_hits[:, 0] < rt1)
        assert torch.equal(hc.hit_tiles(state, part, rt0), all_hits[keep])
    for bad in ((-1, 1), (2, 1), (0, R + 1)):
        with pytest.raises(ValueError):
            hc.band_counts_plain(state, 350, *bad)
