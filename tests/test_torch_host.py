"""The port's host layer on the search paths, held to the code it replaced
and to the JAX package (CPU, seeded with numpy):

* the vectorised attach (``Search._insertion_rows``) against the dict
  lookup it replaced, and its two errors word for word;
* the vectorised reference windows (``Search._reference_windows``)
  against ``_duration_slice`` per reference and the JAX package's;
* ``VideoHash.many_from_packed_u32``'s objects and the caller's GC state;
* ``ascii_path_array`` against ``np.array(paths, dtype=np.bytes_)``;
* the searches' groups against the JAX package's.
"""

from __future__ import annotations

import gc
import importlib

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_search import _planted_library, jax_hashes, same_groups
from vid_dup_finder_lib_tpu_torch import video_hash as vh
from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
from vid_dup_finder_lib_tpu_torch.search import Search

sm = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")
CPU = torch.device("cpu")
TOL = 0.35


def _dict_rows(entries, insertion_paths) -> np.ndarray:
    """The lookup the vectorised attach replaced: a dict of the insertion
    paths, the last row of a repeated path winning."""
    idx = {p: i for i, p in enumerate(insertion_paths)}
    return np.array([idx[e.src_path] for e in entries], dtype=np.int64)


def _hashes(paths, seed, durations=None):
    rng = np.random.default_rng(seed)
    n = len(paths)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    if durations is None:
        durations = rng.integers(30, 7200, n)
    return tvdf.VideoHash.many_from_packed_u32(packed, paths, durations)


def _library_of(hashes, insertion_paths):
    by_path = {h.src_path: h for h in hashes}
    lib = IncrementalDeviceLibrary(CPU, capacity=len(insertion_paths))
    lib.append(np.stack([by_path[p].packed_u32() for p in insertion_paths]))
    return lib


PATH_SETS = {
    "short": lambda n, rng: [f"h{i:07d}" for i in range(n)],
    "long": lambda n, rng: [f"/media/library/videos/{i:08d}.mp4" for i in range(n)],
    "mixed_lengths": lambda n, rng: [f"/v/{'x' * int(rng.integers(0, 40))}{i}.mp4" for i in range(n)],
    "non_ascii": lambda n, rng: [f"/vidéos/{i:05d}.mp4" for i in range(n)],
    "surrogate": lambda n, rng: [f"/v/{i:05d}\udce9.mp4" for i in range(n)],
}


@pytest.mark.parametrize("paths", sorted(PATH_SETS))
@pytest.mark.parametrize("source", ["batch", "objects"])
def test_attach_order_equals_the_dict_lookup(paths, source):
    """Shuffled insertion paths with 40 unrelated rows among them: the same
    ``_library_order`` as the dict lookup, from a batch's path array and
    from plain objects (non-ASCII paths take the dict itself)."""
    rng = np.random.default_rng(3)
    names = PATH_SETS[paths](3000, rng)
    hashes = _hashes(names, 4)
    if source == "objects":
        hashes = list(hashes)
    extra = [f"/extra/{k}" for k in range(40)]
    insertion = [names[k] for k in rng.permutation(len(names))]
    insertion = insertion[:500] + extra + insertion[500:]
    lib = IncrementalDeviceLibrary(CPU, capacity=len(insertion))
    lib.append(np.zeros((len(insertion), 32), np.uint32))
    s = Search(hashes, device=CPU)
    s.attach_device_library(lib, insertion)
    np.testing.assert_array_equal(s._library_order, _dict_rows(s.entries, insertion))


@pytest.mark.parametrize("as_tuple", [False, True])
def test_attach_repeated_path_takes_its_last_row(as_tuple):
    """A path appended three times maps to its last row; the other rows
    keep theirs."""
    names = [f"/r/{i:04d}.mp4" for i in range(300)]
    hashes = _hashes(names, 5)
    insertion = names[:100] + [names[7]] + names[100:] + [names[7], names[250]]
    if as_tuple:
        insertion = tuple(insertion)
    lib = IncrementalDeviceLibrary(CPU, capacity=len(insertion))
    lib.append(np.zeros((len(insertion), 32), np.uint32))
    s = Search(hashes, device=CPU)
    s.attach_device_library(lib, iter(insertion) if not as_tuple else insertion)
    want = _dict_rows(s.entries, insertion)
    np.testing.assert_array_equal(s._library_order, want)
    entry = [e.src_path for e in s.entries].index(names[7])
    assert s._library_order[entry] == len(insertion) - 2


def test_attach_key_collisions_fall_back_to_the_dict(monkeypatch):
    """Every path under one key: the join cannot tell the rows apart, and
    the dict decides, exactly."""
    names = [f"/media/library/{i:06d}.mp4" for i in range(500)]
    hashes = _hashes(names, 6)
    insertion = [names[k] for k in np.random.default_rng(6).permutation(500)] + names[:3]
    lib = IncrementalDeviceLibrary(CPU, capacity=len(insertion))
    lib.append(np.zeros((len(insertion), 32), np.uint32))
    monkeypatch.setattr(sm, "_path_keys", lambda words: np.zeros(len(words), np.uint64))
    s = Search(hashes, device=CPU)
    s.attach_device_library(lib, insertion)
    np.testing.assert_array_equal(s._library_order, _dict_rows(s.entries, insertion))


def _missing_message(path):
    return (
        f"attach_device_library: entry src_path {path!r}"
        f" has no row in insertion_paths — every Search"
        f" entry must have been appended to the library"
    )


@pytest.mark.parametrize("paths", ["short", "non_ascii"])
def test_attach_missing_path_error_word_for_word(paths):
    """The error names the first entry, in sorted entry order, with no row,
    as the dict lookup's KeyError did."""
    names = PATH_SETS[paths](400, np.random.default_rng(7))
    hashes = _hashes(names, 7)
    s = Search(hashes, device=CPU)
    sorted_paths = [e.src_path for e in s.entries]
    gone = {sorted_paths[37], sorted_paths[211]}
    insertion = [p for p in names if p not in gone]
    lib = IncrementalDeviceLibrary(CPU, capacity=len(names))
    lib.append(np.zeros((len(names), 32), np.uint32))
    with pytest.raises(ValueError) as err:
        s.attach_device_library(lib, insertion)
    assert str(err.value) == _missing_message(sorted_paths[37])
    assert err.value.__cause__ is None and err.value.__suppress_context__


def test_attach_out_of_range_error_word_for_word():
    """A row past the library names the entry at argmax of the order."""
    names = [f"h{i:07d}" for i in range(300)]
    hashes = _hashes(names, 8)
    insertion = names + [names[11]]
    lib = IncrementalDeviceLibrary(CPU, capacity=len(names))
    lib.append(np.zeros((len(names), 32), np.uint32))
    s = Search(hashes, device=CPU)
    with pytest.raises(ValueError) as err:
        s.attach_device_library(lib, insertion)
    assert str(err.value) == (
        f"attach_device_library: insertion_paths puts entry {names[11]!r}"
        f" at row {len(names)} but the library holds only {len(names)} rows"
    )


def test_attached_search_groups_match_the_jax_package():
    """The shuffled resident library through the vectorised attach gives
    the JAX package's groups, and so do the upload path and the batched
    references search over it."""
    hashes, planted, _ = _planted_library(5000, 30, seed=21)
    perm = np.random.default_rng(21).permutation(len(hashes))
    insertion = [hashes[k].src_path for k in perm]
    lib = _library_of(hashes, insertion)
    want = jvdf.search(jax_hashes(hashes), TOL, backend="host")
    assert {frozenset(g.contained_paths()) for g in want} == planted
    got = tvdf.search(hashes, TOL, backend="device", device=CPU, device_library=lib,
                      library_paths=insertion)
    assert same_groups(got, want)
    assert same_groups(tvdf.search(hashes, TOL, backend="device", device=CPU), want)
    refs = tvdf.VideoHash.many_from_packed_u32(
        np.stack([hashes[k].packed_u32() for k in range(0, 5000, 50)]),
        [f"/refs/{k}" for k in range(100)], [hashes[k].duration for k in range(0, 5000, 50)])
    want_refs = jvdf.search_with_references(jax_hashes(refs), jax_hashes(hashes), TOL)
    for r in (refs, list(refs)):
        assert same_groups(tvdf.search_with_references(
            r, hashes, TOL, device=CPU, device_library=lib, library_paths=insertion), want_refs)


# -- the reference windows -------------------------------------------------------


def _edge_durations():
    """Durations where d * 0.95 or d * 1.05 lands within 1e-9 of an
    integer (multiples of 20), the small and the u32 edges."""
    near = [d for d in range(0, 20_000)
            if min(abs(d * f - round(d * f)) for f in (0.95, 1.05)) < 1e-9]
    big = [2**32 - 1 - k for k in range(0, 400, 7)] + [2**32 - 20, 2**31, 2**31 + 20]
    return sorted(set([0, 1, 19, 20, 21, 100, 2**32 - 1] + near[:200] + near[-50:] + big))


@pytest.mark.parametrize("refs_as", ["batch", "list"])
def test_windows_equal_duration_slice_and_the_jax_package(refs_as):
    edges = _edge_durations()
    rng = np.random.default_rng(9)
    cand_durs = np.sort(np.concatenate([edges, rng.choice(edges, 300),
                                        rng.integers(0, 2**32, 300)]))
    cands = _hashes([f"/c/{i:05d}" for i in range(len(cand_durs))], 9, cand_durs)
    ref_durs = np.concatenate([edges, [e + k for e in edges[:50] for k in (-1, 1) if e + k >= 0]])
    ref_durs = rng.permutation(ref_durs)  # unsorted, with ties
    refs = _hashes([f"/r/{i:05d}" for i in range(len(ref_durs))], 10, ref_durs)
    if refs_as == "list":
        refs = list(refs)
    s = Search(cands, device=CPU)
    j = jvdf.Search(jax_hashes(cands))
    order, lo, hi = s._reference_windows(refs)
    assert order.tolist() == sorted(range(len(refs)), key=lambda k: refs[k].duration)
    want = [s._duration_slice(refs[k].duration) for k in order]
    assert list(zip(lo.tolist(), hi.tolist())) == want
    assert want == [j._duration_slice(refs[k].duration) for k in order]


def test_windows_keep_fractional_and_huge_durations_exact():
    """Durations outside the u32 contract still get ``int(float(d) * f)``:
    fractional ones through float64, ones past int64 per reference."""
    cands = _hashes([f"/c/{i}" for i in range(50)], 11, np.arange(0, 5000, 100))
    s = Search(cands, device=CPU)
    refs = [vh.VideoHash.empty_hash(f"/r/{k}").with_duration(d)
            for k, d in enumerate([21.5, 100.9, 40, 3.999])]
    order, lo, hi = s._reference_windows(refs)
    assert list(zip(lo.tolist(), hi.tolist())) == [s._duration_slice(refs[k].duration) for k in order]
    refs.append(vh.VideoHash.empty_hash("/r/huge").with_duration(2**70))
    order, lo, hi = s._reference_windows(refs)
    assert order.tolist() == sorted(range(len(refs)), key=lambda k: refs[k].duration)
    assert list(zip(lo.tolist(), hi.tolist())) == [s._duration_slice(refs[k].duration) for k in order]


def test_reference_matrix_of_a_batch_and_of_objects():
    refs = _hashes([f"/r/{i}" for i in range(64)], 12)
    order = np.random.default_rng(12).permutation(64)
    want = vh.hashes_to_matrix([refs[k] for k in order])
    np.testing.assert_array_equal(Search._reference_matrix(refs, order), want)
    np.testing.assert_array_equal(Search._reference_matrix(list(refs), order), want)
    refs.append(refs[0])  # a mutated batch: its arrays are stale
    np.testing.assert_array_equal(Search._reference_matrix(refs, order), want)


# -- bulk objects and the caller's GC ----------------------------------------------


@pytest.mark.parametrize("enabled", [True, False])
def test_many_from_packed_u32_leaves_gc_as_found(enabled, monkeypatch):
    """The caller's GC state survives a bulk build, a large one (which
    collects once, and only when the caller's GC is on) and one that
    raises."""
    was = gc.isenabled()
    collections = []

    def count(phase, info):
        if phase == "start":
            collections.append(info["generation"])

    gc.callbacks.append(count)
    try:
        (gc.enable if enabled else gc.disable)()
        names = [f"/g/{i}" for i in range(200)]
        batch = _hashes(names, 13)
        assert gc.isenabled() is enabled
        monkeypatch.setattr(vh, "GC_SETTLE_MIN", 100)
        collections.clear()
        again = vh.VideoHash.many_from_packed_u32(batch.packed_u32, names, batch.durations)
        assert again == batch and gc.isenabled() is enabled
        assert bool(collections) is enabled
        with pytest.raises(ValueError, match="all three must match"):
            vh.VideoHash.many_from_packed_u32(batch.packed_u32, names[:-1], batch.durations)
        assert gc.isenabled() is enabled

        def boom(*args, **kwargs):
            raise RuntimeError("inside the loop")

        monkeypatch.setattr(vh, "deque", boom)
        with pytest.raises(RuntimeError, match="inside the loop"):
            vh.VideoHash.many_from_packed_u32(batch.packed_u32, names, batch.durations)
        assert gc.isenabled() is enabled
    finally:
        gc.callbacks.remove(count)
        (gc.enable if was else gc.disable)()


@pytest.mark.parametrize("durations", ["int64", "uint32", "list", "numpy_scalars"])
def test_many_from_packed_u32_objects_equal_from_packed_u32(durations):
    rng = np.random.default_rng(14)
    packed = rng.integers(0, 2**32, (300, 32), dtype=np.uint64).astype(np.uint32)
    durs = rng.integers(0, 2**32, 300, dtype=np.int64)
    names = [f"/o/{i}" for i in range(300)]
    given = {"int64": durs, "uint32": durs.astype(np.uint32), "list": durs.tolist(),
             "numpy_scalars": list(durs)}[durations]
    batch = vh.VideoHash.many_from_packed_u32(packed, iter(names), given)
    assert type(batch) is vh.VideoHashBatch and batch.arrays_valid
    assert batch == [vh.VideoHash.from_packed_u32(packed[i], names[i], int(durs[i]))
                     for i in range(300)]
    assert all(type(h.duration) is int and type(h) is vh.VideoHash for h in batch)
    assert all(not h.hash.flags.writeable for h in batch)
    np.testing.assert_array_equal(batch.durations, durs)
    assert batch.durations.dtype == np.int64
    np.testing.assert_array_equal(batch.paths_bytes, np.array(names, dtype=np.bytes_))
    assert hash(batch[5]) == hash(vh.VideoHash.from_packed_u32(packed[5], names[5], int(durs[5])))
    assert batch[5].to_json() == vh.VideoHash.from_packed_u32(packed[5], names[5], int(durs[5])).to_json()
    empty = vh.VideoHash.many_from_packed_u32(packed[:0], [], [])
    assert empty == [] and empty.paths_bytes is None and empty.packed_u32.shape == (0, 32)


@pytest.mark.parametrize("case", ["equal", "mixed", "empty_strings", "one"])
def test_ascii_path_array_equals_numpy_bytes(case):
    rng = np.random.default_rng(15)
    paths = {
        "equal": [f"p{i:05d}" for i in range(100)],
        "mixed": ["".join(chr(c) for c in rng.integers(1, 128, int(rng.integers(0, 30))))
                  for _ in range(200)],
        "empty_strings": ["", "", "a", ""],
        "one": ["only"],
    }[case]
    got = vh.ascii_path_array(paths)
    want = np.array(paths, dtype=np.bytes_)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("paths", [[], ["a", "é"], ["a", "b\x00"], ["a\x00b"], ["a", b"b"], ["a", 3]])
def test_ascii_path_array_refuses(paths):
    assert vh.ascii_path_array(paths) is None


def test_staging_refuses_what_it_cannot_copy():
    """The staging copies host bytes to a CUDA tensor of the same size and
    refuses anything else before it touches the card."""
    from vid_dup_finder_lib_tpu_torch.utils import staging

    with pytest.raises(ValueError, match="host to CUDA"):
        staging.upload_into(torch.empty(4), np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="host to CUDA"):
        staging.PinnedStaging().copy(torch.empty(4), torch.empty(4))


@pytest.mark.parametrize("n", [1, 7, 5000])
def test_adjacency_offsets_equal_the_searchsorted_csr(n):
    rng = np.random.default_rng(n)
    pairs_i = np.sort(rng.integers(0, n, 3 * n))
    np.testing.assert_array_equal(Search._adjacency_offsets(pairs_i, n),
                                  np.searchsorted(pairs_i, np.arange(n + 1)))
    np.testing.assert_array_equal(Search._adjacency_offsets(pairs_i[:0], n), np.zeros(n + 1, np.int64))


@pytest.mark.parametrize("backend", ["device", "host", "naive"])
def test_search_self_computes_the_bounds_once(monkeypatch, backend):
    """One ``_self_search_bounds`` per search (the adjacency's, or the
    pairwise loop's), and the JAX package's groups."""
    hashes, _, _ = _planted_library(600, 8, seed=23)
    calls = []
    real = Search._self_search_bounds
    monkeypatch.setattr(Search, "_self_search_bounds", lambda self: calls.append(1) or real(self))
    got = tvdf.search(hashes, TOL, backend=backend, device=CPU)
    assert len(calls) == 1
    assert same_groups(got, jvdf.search(jax_hashes(hashes), TOL, backend="naive"))
