"""The port's device-resident library (``IncrementalDeviceLibrary`` and
``Search.attach_device_library``) against the JAX package.

Searches over a library attached in shuffled, identity and superset
insertion orders must give the JAX package's groups, in the same order,
whether the JAX side searches naively or over its own attached library;
pairs are held exactly.  The port runs its kernels' plain versions here
(CPU tensors); the JAX library runs its Pallas sweep in interpret mode.
"""

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_search_device_library import _problem
from tests.test_torch_hamming import _flip
from tests.test_torch_search import _planted_library, jax_hashes, port_hashes, same_groups
from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp
from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
from vid_dup_finder_lib_tpu_torch.convert import library_from_numpy
from vid_dup_finder_lib_tpu_torch.ops import hamming_band as hb
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
from vid_dup_finder_lib_tpu_torch.search import Search

CPU = torch.device("cpu")
TOL = 0.35


def _rows(hashes):
    return np.stack([h.packed_u32() for h in hashes])


def _sorted(hashes):
    return sorted(hashes, key=lambda h: (h.duration, h.src_path.encode()))


@pytest.fixture(scope="module")
def planted():
    hashes, groups, starts = _planted_library(700, 12, seed=41)
    return hashes, groups, starts


def _library(hashes, insertion, seed=0, capacity=4096):
    """(library, insertion paths) for one insertion order:

    * ``shuffled``: a seeded permutation;
    * ``identity``: sorted (duration, path) order, ``library_paths=None``;
    * ``superset``: shuffled, with 50 unrelated rows among them."""
    rng = np.random.default_rng(seed)
    if insertion == "identity":
        rows = _sorted(hashes)
    else:
        rows = [hashes[k] for k in rng.permutation(len(hashes))]
    if insertion == "superset":
        extra = [
            tvdf.VideoHash.random_hash(rng).with_src_path(f"/extra/{k}")
            for k in range(50)
        ]
        rows = rows[:100] + extra + rows[100:]
    lib = IncrementalDeviceLibrary(CPU, capacity=capacity)
    lib.append(_rows(rows))
    return lib, None if insertion == "identity" else [h.src_path for h in rows]


@pytest.mark.parametrize("backend", ["auto", "device", "band"])
@pytest.mark.parametrize("insertion", ["shuffled", "identity", "superset"])
def test_library_search_matches_jax(planted, insertion, backend):
    hashes, groups, _ = planted
    lib, paths = _library(hashes, insertion)
    ours = tvdf.search(
        hashes, TOL, backend=backend, device=CPU, device_library=lib, library_paths=paths
    )
    assert same_groups(ours, jvdf.search(jax_hashes(hashes), TOL, backend="naive"))
    assert {frozenset(g.contained_paths()) for g in ours} == groups


@pytest.mark.parametrize("insertion", ["shuffled", "identity"])
def test_library_search_matches_jax_library(insertion):
    """Both packages over their own attached library, on the JAX
    package's device-library problem (random durations)."""
    theirs, tol = _problem(seed=7)
    hashes = port_hashes(theirs)
    lib, paths = _library(hashes, insertion, seed=3)
    jlib = hp.IncrementalDeviceLibrary()
    jlib.append(lib.packed[: lib.n].numpy().view(np.uint32))
    want = jvdf.search(theirs, tol, backend="pallas", device_library=jlib, library_paths=paths)
    assert len(want) >= 3
    got = tvdf.search(hashes, tol, device=CPU, device_library=lib, library_paths=paths)
    assert same_groups(got, want)
    assert want == jvdf.search(theirs, tol, backend="naive")


@pytest.mark.parametrize("tol", [0, 350, 1100])
def test_library_state_pairs_exact(planted, tol):
    """A state gathered from a shuffled library sweeps the same pairs as
    the JAX package's host sweep over the sorted matrix, on both the
    two-phase sweep and K4."""
    hashes, _, _ = planted
    lib, paths = _library(hashes, "shuffled")
    s = Search(hashes, device=CPU)
    s.attach_device_library(lib, paths)
    bounds = s._self_search_bounds()
    st = lib.state(s._library_order, bounds)
    want = banded_adjacency_host(_rows(s.entries), bounds, tol)
    for got in (hc.banded_adjacency_cuda(st, tol), hb.banded_adjacency_band(None, None, tol, state=st)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_identity_state_is_zero_copy_and_gather_is_not(planted):
    hashes, _, _ = planted
    lib, _ = _library(hashes, "identity")
    order = np.arange(lib.n)
    bounds = np.full(lib.n, lib.n)
    st = lib.state(order, bounds)
    assert st.packed.data_ptr() == lib.packed.data_ptr()
    assert st.rows is st.packed and st.packed.shape == (st.n_pad, 32)
    # a permutation, or a subset, gathers into a fresh tensor
    for o in (order[::-1].copy(), order[:-1]):
        g = lib.state(o, np.full(len(o), len(o)))
        assert g.packed.data_ptr() != lib.packed.data_ptr()
        np.testing.assert_array_equal(g.packed[: len(o)].numpy(), lib.packed[o].numpy())


def test_state_unchanged_by_a_later_append(planted):
    """A zero-copy state shares its storage with the library; an append
    after it writes rows past the state's n into that storage (its pad
    rows), and the sweeps must not see them."""
    hashes, _, _ = planted
    lib, _ = _library(hashes, "identity")
    n = lib.n
    assert n % hc.TILE, "the library must end inside a tile"
    entries = _sorted(hashes)
    bounds = np.full(n, n)  # every row's window reaches the last column
    st = lib.state(np.arange(n), bounds)
    before = hc.banded_adjacency_cuda(st, 350)
    before_band = hb.banded_adjacency_band(None, None, 350, state=st)
    # copies of every row of the last tile: each would match its source
    tail = _rows(entries[n - n % hc.TILE :])
    lib.append(tail)
    assert st.packed.data_ptr() == lib.packed.data_ptr()
    assert st.packed[n:].any(), "the append reached the state's pad rows"
    for got in (
        hc.banded_adjacency_cuda(st, 350),
        hb.banded_adjacency_band(None, None, 350, state=st),
        before_band,
    ):
        np.testing.assert_array_equal(got[0], before[0])
        np.testing.assert_array_equal(got[1], before[1])
    # the new state over all rows does see the copies
    grown = lib.state(np.arange(lib.n), np.full(lib.n, lib.n))
    assert len(hc.banded_adjacency_cuda(grown, 350)[0]) >= len(before[0]) + len(tail)


def test_growth_across_capacity_doublings(planted):
    hashes, groups, _ = planted
    rows = _rows(hashes)
    lib = IncrementalDeviceLibrary(CPU, capacity=100)
    assert lib.capacity == hc.TILE  # rounded up to whole tiles
    for k0 in range(0, len(rows), 90):
        lib.append(rows[k0 : k0 + 90])
        assert lib.n == min(k0 + 90, len(rows))
        assert lib.capacity >= lib.n and lib.capacity % hc.TILE == 0
    assert lib.capacity == 1024  # 128 -> 256 -> 512 -> 1024
    np.testing.assert_array_equal(lib.packed[: lib.n].numpy().view(np.uint32), rows)
    assert not lib.packed[lib.n :].any()
    got = tvdf.search(
        hashes, TOL, device=CPU, device_library=lib,
        library_paths=[h.src_path for h in hashes],
    )
    assert {frozenset(g.contained_paths()) for g in got} == groups


def test_cpu_append_copies_the_callers_rows():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 2**32, (10, 32), dtype=np.uint64).astype(np.uint32)
    keep = rows.copy()
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(rows)
    rows[:] = 0
    np.testing.assert_array_equal(lib.take_rows(np.arange(10)), keep)
    lib2 = library_from_numpy(keep, CPU)
    keep[:] = 1
    assert not (lib2.take_rows([0]) == 1).all()


def test_library_from_jax_library_rows(planted):
    hashes, groups, _ = planted
    jlib = hp.IncrementalDeviceLibrary()
    jlib.append(_rows(hashes))
    lib = library_from_numpy(np.asarray(jlib._packed[: jlib.n]), "cpu")
    assert lib.n == len(hashes) and lib.device == CPU
    got = tvdf.search(
        hashes, TOL, device=CPU, device_library=lib,
        library_paths=[h.src_path for h in hashes],
    )
    assert {frozenset(g.contained_paths()) for g in got} == groups


def test_seed_detaches_and_forgets_the_sort_check():
    """Fault in the reference: its ``seed()`` keeps ``_ctor_resorted``, so
    a later identity attach skips the spot-check of the library's order.
    The port resets it, and a misaligned library is refused."""
    theirs, tol = _problem(seed=19, groups=2)
    hashes = port_hashes(theirs)
    entries = _sorted(hashes)
    s = Search(entries[:-1], device=CPU)
    assert s._ctor_resorted is False
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(_rows(entries[:-1]))
    s.attach_device_library(lib, None)
    s.seed([entries[-1]])
    assert s._library is None and s._cands_dev is None and s._library_order is None
    assert s._ctor_resorted is None
    wrong = IncrementalDeviceLibrary(CPU)
    wrong.append(_rows(entries[::-1]))  # right rows, wrong order
    with pytest.raises(ValueError, match="does not match"):
        s.attach_device_library(wrong, None)
    right = IncrementalDeviceLibrary(CPU)
    right.append(_rows(entries))
    s.attach_device_library(right, None)
    got = s.search_self(tol)
    want = jvdf.search(theirs, tol, backend="naive")
    assert [sorted(g) for g in got if len(g) >= 2] == [sorted(g.contained_paths()) for g in want]


def test_duplicate_insertion_paths_past_the_library_raise(planted):
    """Fault in the reference: it compares ``library.n`` with the number of
    distinct insertion paths, so a repeated path whose last row lies past
    the library gets through.  The port checks the rows the entries use."""
    hashes, _, _ = planted
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(_rows(hashes))
    paths = [h.src_path for h in hashes]
    s = Search(hashes, device=CPU)
    with pytest.raises(ValueError, match=f"holds only {len(hashes)} rows"):
        s.attach_device_library(lib, paths + [paths[3]])
    # a repeat whose last row is inside the library is legal: the last row wins
    lib.append(_rows(hashes[3:4]))
    s.attach_device_library(lib, paths + [paths[3]])
    assert s._library_order[[e.src_path for e in s.entries].index(paths[3])] == len(hashes)


def test_other_attach_errors(planted):
    hashes, _, _ = planted
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(_rows(hashes[:-1]))
    s = Search(hashes, device=CPU)
    with pytest.raises(ValueError, match="has no row in insertion_paths"):
        s.attach_device_library(lib, [h.src_path for h in hashes[:-1]])
    with pytest.raises(ValueError, match="exactly one row per entry"):
        s.attach_device_library(lib, None)
    with pytest.raises(ValueError):
        lib.state(np.array([0, lib.n]), np.array([2, 2]))


def test_library_on_another_device_raises(planted):
    hashes, _, _ = planted
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(_rows(hashes))
    lib.device = torch.device("cuda", 0)  # as a library on the card reports
    with pytest.raises(ValueError, match="lies on cuda:0"):
        tvdf.search(hashes, TOL, device=CPU, device_library=lib,
                    library_paths=[h.src_path for h in hashes])


@pytest.mark.parametrize("backend", ["auto", "device", "band"])
def test_library_path_never_builds_the_host_matrix(planted, monkeypatch, backend):
    hashes, groups, starts = planted
    lib, paths = _library(hashes, "shuffled")

    def refuse(self):
        raise AssertionError("host packed matrix built on the library path")

    monkeypatch.setattr(Search, "_packed_matrix", refuse)
    got = tvdf.search(
        hashes, TOL, backend=backend, device=CPU, device_library=lib, library_paths=paths
    )
    assert {frozenset(g.contained_paths()) for g in got} == groups
    refs = [hashes[s].with_src_path(f"/ref/{k}") for k, s in enumerate(starts)]
    found = tvdf.search_with_references(
        refs, hashes, TOL, device=CPU, device_library=lib, library_paths=paths
    )
    assert len(found) == len(refs)


@pytest.fixture(scope="module")
def refs_problem(planted):
    hashes, _, starts = planted
    rng = np.random.default_rng(43)
    refs = [
        tvdf.VideoHash.from_packed_u32(_flip(hashes[s].packed_u32(), rng, 40))
        .with_src_path(f"/ref/p{k}").with_duration(hashes[s].duration)
        for k, s in enumerate(starts)
    ]
    refs += [
        tvdf.VideoHash.random_hash(rng).with_src_path(f"/ref/r{k}")
        .with_duration(int(rng.integers(30, 7200)))
        for k in range(60)
    ]
    return hashes, [refs[k] for k in rng.permutation(len(refs))]


@pytest.mark.parametrize("n_refs", [5, 72])
@pytest.mark.parametrize("insertion", ["shuffled", "identity", "superset"])
def test_refs_search_through_a_library(refs_problem, insertion, n_refs):
    """Through a library, equal to the upload path and to the JAX package
    (which loops per reference below 64 references)."""
    hashes, refs = refs_problem
    refs = refs[:n_refs]
    lib, paths = _library(hashes, insertion)
    ours = tvdf.search_with_references(
        refs, hashes, TOL, device=CPU, device_library=lib, library_paths=paths
    )
    assert ours == tvdf.search_with_references(refs, hashes, TOL, device=CPU)
    assert same_groups(ours, jvdf.search_with_references(jax_hashes(refs), jax_hashes(hashes), TOL))
    assert any(g.reference.startswith("/ref/p") for g in ours)


def test_refs_search_matches_jax_library(refs_problem):
    hashes, refs = refs_problem
    lib, paths = _library(hashes, "shuffled")
    jlib = hp.IncrementalDeviceLibrary()
    jlib.append(lib.packed[: lib.n].numpy().view(np.uint32))
    assert same_groups(
        tvdf.search_with_references(
            refs, hashes, TOL, device=CPU, device_library=lib, library_paths=paths
        ),
        jvdf.search_with_references(
            jax_hashes(refs), jax_hashes(hashes), TOL, device_library=jlib, library_paths=paths
        ),
    )


def test_resident_state_operands_match_host_ones(planted):
    hashes, _, _ = planted
    rows = _rows(_sorted(hashes))
    n = len(rows)
    lib = IncrementalDeviceLibrary(CPU)
    lib.append(rows)
    lo = np.maximum(np.arange(0, n, 3) - 20, 0)
    hi = np.minimum(lo + 90, n)
    refs = rows[::3]
    want = hc.refs_adjacency_plain(hc.RefsState(refs, rows, lo, hi, CPU), 350)
    st = hc.RefsState(refs, lib.packed, lo, hi, CPU, n_cands=n)
    assert st.cols.data_ptr() == lib.packed.data_ptr()
    assert st.cols.shape[0] == -(-n // hc.TILE) * hc.TILE
    got = hc.refs_adjacency_plain(st, 350)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="row count"):
        hc.SearchState(lib.packed, np.full(n, n), CPU)
    with pytest.raises(ValueError, match="int32"):
        hc.SearchState(lib.packed[:10], np.full(n, n), CPU, n=n)
    with pytest.raises(ValueError, match="int32"):
        hc.SearchState(lib.packed.to(torch.int64), np.full(n, n), CPU, n=n)
