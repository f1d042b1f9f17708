"""The port's references search (K2/K3 in their per-row window mode)
against the JAX package: ``refs_adjacency`` against
``refs_adjacency_pallas`` (interpret mode on the CPU) and a brute-force
popcount, and the public ``search_with_references`` and
``Search.search_with_references_batched`` against the JAX package's.

Inputs are made with NumPy from a seed; pairs, matches and groups are held
exactly.  Two subprocess tests show that the port's references search
never reaches jax.  The batched search is held here on the plain window-mode
versions (``VDF_REFS_NATIVE=0``); tests/test_torch_native.py holds the native
windowed sweep a CPU Search takes by default.
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_hamming import LIBRARIES, _flip, _library
from tests.test_torch_search import _planted_library, jax_hashes, same_groups
from vid_dup_finder_lib_tpu.ops.hamming_pallas import refs_adjacency_pallas
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops.hamming import refs_adjacency

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def plain_window_mode(monkeypatch):
    """The batched references search through K2/K3's plain versions, in
    both packages, not through the native windowed sweep."""
    monkeypatch.setenv("VDF_REFS_NATIVE", "0")


def _brute_force(refs, cands, lo, hi, tol):
    dist = np.bitwise_count(refs[:, None, :] ^ cands[None, :, :]).sum(2)
    return [
        (i, j)
        for i in range(len(refs))
        for j in range(max(int(lo[i]), 0), min(int(hi[i]), len(cands)))
        if dist[i, j] <= tol
    ]


def _windowed_case(n, r, seed):
    """Duration-sorted refs and candidates with [0.95d, 1.05d] windows,
    planted matches, an empty window, a reversed one and one past n."""
    rng = np.random.default_rng(seed)
    cands = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    refs = rng.integers(0, 2**32, (r, 32), dtype=np.uint64).astype(np.uint32)
    cd = np.sort(rng.integers(50, 500, n))
    rd = np.sort(rng.integers(50, 500, r))
    lo = np.searchsorted(cd, (rd * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(cd, (rd * 1.05).astype(np.int64), "right")
    for k in range(0, r, 25):  # planted matches inside the window
        if hi[k] > lo[k]:
            refs[k] = _flip(cands[lo[k] + (hi[k] - lo[k]) // 2], rng, 60)
    hi[r // 3] = lo[r // 3]
    hi[r // 2] = max(lo[r // 2] - 5, 0)
    hi[-1] = n + 40
    return refs, cands, lo, hi


def refs_case(packed, bounds):
    """References from a library of tests/test_torch_hamming.py: every third
    row (a ragged count) as a ref, against the library, with windows that
    start before the row, one empty, one reversed and one past n."""
    n = len(packed)
    idx = np.arange(0, n, 3)
    lo = np.maximum(idx - 37, 0)
    hi = np.minimum(bounds[idx], n).astype(np.int64)
    if len(idx) > 2:
        hi[1], hi[2] = lo[1], lo[2] - 1
        hi[-1] = n + 99
    return packed[idx], packed, lo, hi


CASES = {
    "windowed1000x333": lambda: _windowed_case(1000, 333, 30),
    "windowed300x200": lambda: _windowed_case(300, 200, 31),
    **{
        f"lib_{name}": (lambda name=name: refs_case(*_library(name)))
        for name in ("random900", "dense300", "pad_bits", "ragged130", "single")
    },
}


@pytest.mark.parametrize("tol", [0, 350, 470, 1100])
@pytest.mark.parametrize("case", list(CASES))
def test_refs_adjacency_matches_bruteforce(case, tol):
    refs, cands, lo, hi = CASES[case]()
    pi, pj = refs_adjacency(refs, cands, lo, hi, tol, device=CPU)
    assert pi.dtype == np.int64 and pj.dtype == np.int64
    assert list(zip(pi.tolist(), pj.tolist())) == _brute_force(refs, cands, lo, hi, tol)


@pytest.mark.parametrize("tol", [350, 470])
@pytest.mark.parametrize("case", ["windowed1000x333", "windowed300x200", "lib_ragged130"])
def test_refs_adjacency_matches_jax_pallas_interpret(case, tol):
    refs, cands, lo, hi = CASES[case]()
    ji, jj = refs_adjacency_pallas(refs, cands, lo, hi, tol, interpret=True)
    ti, tj = refs_adjacency(refs, cands, lo, hi, tol, device=CPU)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tj, jj)
    if tol == 470 and case.startswith("windowed"):
        assert len(ti) > 0


@functools.lru_cache(maxsize=None)
def _slab_references(case):
    """What every slabbed sweep of ``case`` must give: the one-slab
    sweep's pairs at 350 and 470 bits, which equal the brute force's and,
    at 470, the JAX package's Pallas sweep's; and the whole plain counts."""
    refs, cands, lo, hi = CASES[case]()
    state = hc.RefsState(refs, cands, lo, hi, CPU)
    one = {tol: hc.refs_adjacency_cuda(state, tol, counts_budget=10**12) for tol in (350, 470)}
    for tol, (i, j) in one.items():
        assert list(zip(i.tolist(), j.tolist())) == _brute_force(refs, cands, lo, hi, tol)
    ji, jj = refs_adjacency_pallas(refs, cands, lo, hi, 470, interpret=True)
    np.testing.assert_array_equal(one[470][0], ji)
    np.testing.assert_array_equal(one[470][1], jj)
    return state, one, hc.band_counts_plain(state, 470)


@pytest.mark.parametrize("budget", [10**12, "two", "many", 1])
@pytest.mark.parametrize("case", ["windowed1000x333", "windowed300x200", "lib_random900",
                                  "lib_dense300", "lib_ragged130"])
def test_slabbed_refs_sweep_matches_one_slab_bruteforce_and_pallas(case, budget):
    """Window mode in slabs of ref tiles: budgets that give one slab, two,
    many, and one ref tile each give the one-slab sweep's pairs, in order."""
    from tests.test_torch_hamming import budget_for

    state, one, whole = _slab_references(case)
    R = state.n_row_tiles
    if budget == "two":
        budget = budget_for(state, min(2, R))
    elif budget == "many":
        budget = budget_for(state, min(3, R))
    cut = hc.count_slabs(state, budget)
    assert cut[0][0] == 0 and cut[-1][1] == R
    assert len(cut) == (1 if budget == 10**12 else R if budget == 1 else len(cut))
    for tol, want in one.items():
        got = hc.refs_adjacency_cuda(state, tol, counts_budget=budget)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    # (on a CPU state refs_adjacency_cuda runs the plain versions)
    # the range form of the plain counts: rows of the whole
    for rt0, rt1 in cut:
        part = hc.band_counts_plain(state, 470, rt0, rt1)
        assert torch.equal(part, whole[rt0:rt1, : part.shape[1]])
        assert not whole[rt0:rt1, part.shape[1] :].any()


def _expected_tiles(state, pairs):
    """Per-tile counts and transposed words implied by (ref, cand) pairs."""
    T = hc.TILE
    counts = np.zeros((state.n_row_tiles, state.slots), np.int64)
    words = {}
    for i, j in pairs:
        rt, ct = i // T, j // T
        counts[rt, ct - state.first_ct[rt]] += 1
        w = words.setdefault((rt, ct), np.zeros((T // 32, T), np.uint32))
        w[(i % T) // 32, j % T] |= np.uint32(1) << np.uint32(i % 32)
    return counts, words


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_window_mode_counts_and_words(case, tol):
    refs, cands, lo, hi = CASES[case]()
    state = hc.RefsState(refs, cands, lo, hi, CPU)
    counts, words = _expected_tiles(state, _brute_force(refs, cands, lo, hi, tol))
    got = hc.band_counts_plain(state, tol)
    np.testing.assert_array_equal(got.numpy(), counts)
    hits = hc.hit_tiles(state, got)
    packed = hc.band_pack_plain(state, hits, tol).numpy().view(np.uint32)
    for h, (rt, ct) in enumerate(hits.tolist()):
        np.testing.assert_array_equal(packed[h], words[(rt, ct)])
    assert len(hits) == len(words)


def test_refs_state_layout_and_metadata():
    refs, cands, lo, hi = _windowed_case(1000, 333, 30)
    st = hc.RefsState(refs, cands, lo, hi, CPU)
    assert st.n == 1000 and st.n_rows == 333 and st.n_row_tiles == 3
    assert st.rows.shape == (384, 32) and st.cols.shape == (1024, 32)
    assert not st.rows[333:].any() and not st.cols[1000:].any()
    np.testing.assert_array_equal(st.rows[:333].numpy().view(np.uint32), refs)
    row_lo, bounds = st.row_lo.numpy(), st.bounds.numpy()
    np.testing.assert_array_equal(row_lo[:333], lo - 1)
    np.testing.assert_array_equal(bounds[:333], np.minimum(hi, 1000))
    assert (row_lo[333:] == hc.ROW_LO_SENTINEL).all() and (bounds[333:] == -1).all()
    # every window lies in its tile's band; the tiles are not diagonal
    T = hc.TILE
    for i in range(333):
        if hi[i] > lo[i]:
            rt = i // T
            assert st.first_ct[rt] <= lo[i] // T
            assert (min(hi[i], 1000) - 1) // T < st.first_ct[rt] + st.n_ct[rt]
    assert st.first_ct[0] == 0 and st.first_ct[-1] > 2
    assert st.comparisons() == int(np.maximum(np.minimum(hi, 1000) - lo, 0).sum())


def test_refs_launch_metadata_edges():
    T = hc.TILE
    # one tile of empty windows high up the candidates, one ragged tile
    row_lo = np.array([5 * T - 1] * T + [-1, 10, 3 * T], np.int64)
    bounds = np.array([5 * T - 1] * T + [0, 9, 3 * T + 1], np.int64)
    first_ct, n_ct = hc.refs_launch_metadata(row_lo, bounds, 2)
    assert first_ct.tolist() == [5, 0]
    assert n_ct.tolist() == [0, 4]
    assert (n_ct >= 0).all()


def test_refs_state_rejects_bad_shapes():
    packed = np.zeros((4, 32), np.uint32)
    with pytest.raises(ValueError):
        hc.RefsState(packed, np.zeros((4, 31), np.uint32), [0] * 4, [1] * 4, CPU)
    with pytest.raises(ValueError):
        hc.RefsState(packed, packed, [0] * 3, [1] * 4, CPU)


def test_refs_adjacency_empty_inputs():
    some = np.ones((5, 32), np.uint32)
    none = np.zeros((0, 32), np.uint32)
    for refs, cands in ((none, some), (some, none)):
        i, j = refs_adjacency(refs, cands, [0] * len(refs), [5] * len(refs), 1100, CPU)
        assert i.dtype == np.int64 and len(i) == len(j) == 0


@pytest.fixture(scope="module")
def library():
    hashes, _, starts = _planted_library(1000, 24, seed=33)
    rng = np.random.default_rng(34)
    refs = [  # near copies of planted entries, then random hashes
        tvdf.VideoHash.from_packed_u32(_flip(hashes[s].packed_u32(), rng, 40))
        .with_src_path(f"/ref/p{k}").with_duration(hashes[s].duration)
        for k, s in enumerate(starts)
    ]
    refs += [
        tvdf.VideoHash.random_hash(rng).with_src_path(f"/ref/r{k}")
        .with_duration(int(rng.integers(30, 7200)))
        for k in range(90)
    ]
    order = rng.permutation(len(refs))  # input order is not duration order
    return hashes, [refs[k] for k in order]


@pytest.mark.parametrize("tolerance", [0.0, 0.35, 0.5])
def test_search_with_references_matches_jax(library, tolerance):
    hashes, refs = library
    assert len(refs) >= 64
    ours = tvdf.search_with_references(refs, hashes, tolerance, device=CPU)
    assert same_groups(
        ours, jvdf.search_with_references(jax_hashes(refs), jax_hashes(hashes), tolerance)
    )
    if tolerance == 0.35:
        assert sorted(g.reference for g in ours) == sorted(
            f"/ref/p{k}" for k in range(24)
        )


def test_batched_equals_per_ref_loop(library):
    hashes, refs = library
    s = tvdf.Search(hashes, device=CPU)
    loop = [s.search_one(r, 0.35, consume=False) for r in refs]
    assert s.search_with_references_batched(refs, 0.35) == loop
    assert sum(map(len, loop)) >= 3 * 24


def test_batched_after_a_consuming_call_filters_matched(library):
    hashes, refs = library
    ours = tvdf.Search(hashes, device=CPU)
    ref_s = jvdf.Search(jax_hashes(hashes))
    first = refs[:10]
    assert ours.search_with_references(first, 0.35, consume=True) == (
        ref_s.search_with_references(jax_hashes(first), 0.35, consume=True)
    )
    assert ours.matched.any()
    got = ours.search_with_references_batched(refs, 0.35)
    assert got == ref_s.search_with_references_batched(jax_hashes(refs), 0.35)
    assert got == [ours.search_one(r, 0.35, consume=False) for r in refs]
    consumed = {ours.entries[j].src_path for j in np.nonzero(ours.matched)[0]}
    assert not consumed & {p for m in got for p in m}


def test_batched_empty_inputs():
    s = tvdf.Search([], device=CPU)
    assert s.search_with_references_batched([], 0.35) == []
    ref = tvdf.VideoHash.random_hash(np.random.default_rng(0))
    assert s.search_with_references_batched([ref], 0.35) == [[]]


def _run(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["VDF_REFS_DEVICE_THRESHOLD"] = "0"
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout


_SETUP = """
    import numpy as np
    import vid_dup_finder_lib_tpu_torch as vdf
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 2**32, (600, 32), dtype=np.uint64).astype(np.uint32)
    packed[1::2] = packed[::2]
    durs = np.repeat(np.sort(rng.integers(30, 7200, 300)), 2)
    hashes = vdf.VideoHash.many_from_packed_u32(packed, [f"v{i}" for i in range(600)], durs)
    refs = [h.with_src_path(f"r{i}") for i, h in enumerate(hashes[::8])]
    assert len(refs) >= 64
    s = vdf.Search(hashes, device="cpu")
    got = s.search_with_references_batched(refs, 0.35)
    assert got == [s.search_one(r, 0.35, consume=False) for r in refs]
    assert all(len(m) == 2 for m in got)
"""


def test_batched_refs_never_import_jax():
    """With jax importable, the port's batched references search loads no
    jax module (the JAX package's method would probe jax's backend)."""
    out = _run(
        _SETUP
        + """
    import sys
    loaded = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
    assert not loaded, loaded
    print("no-jax")
    """
    )
    assert "no-jax" in out


def test_band_and_refs_run_with_jax_unimportable():
    out = _run(
        """
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    """
        + _SETUP
        + """
    groups = vdf.search(hashes, 0.35, backend="band", device="cpu")
    assert len(groups) == 300 and groups == vdf.search(hashes, 0.35, backend="host", device="cpu")
    found = vdf.search_with_references(refs, hashes, 0.35, device="cpu")
    assert len(found) == len(refs)
    assert not any(v is not None for k, v in sys.modules.items()
                   if k == "jax" or k.startswith("jax."))
    print("port-ok")
    """
    )
    assert "port-ok" in out
