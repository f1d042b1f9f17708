"""The port's public search (``vid_dup_finder_lib_tpu_torch.search``) against
the JAX package's ``search`` on its host and Pallas backends.

Groups are held exactly: the same MatchGroups in the same order.  The port
computes the adjacency with the plain versions of its kernels here (CPU
tensors); its greedy replay is its own copy of the JAX package's.  The two
packages share no class: hashes cross between them as packed words, paths
and durations (:func:`jax_hashes`), and groups are compared as
(reference, duplicates) pairs (:func:`same_groups`).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_hamming import _flip
from vid_dup_finder_lib_tpu_torch.ops.hamming_cuda import IncrementalDeviceLibrary
from vid_dup_finder_lib_tpu_torch.search import Search

ORACLE = os.path.join(os.path.dirname(__file__), "oracles", "reference_vids_hashes.json")


def _carried(package, hashes):
    """``package``'s own hashes for the other package's ``hashes``, carried
    across as packed words, paths and durations."""
    hashes = list(hashes)
    return package.VideoHash.many_from_packed_u32(
        np.stack([h.packed_u32() for h in hashes]),
        [h.src_path for h in hashes],
        [h.duration for h in hashes],
    )


jax_hashes = functools.partial(_carried, jvdf)
port_hashes = functools.partial(_carried, tvdf)


def same_groups(ours, theirs):
    """The port's MatchGroups equal the JAX package's, in the same order:
    each package's own class, the same (reference, duplicates)."""
    assert all(type(g) is tvdf.MatchGroup for g in ours)
    assert all(type(g) is jvdf.MatchGroup for g in theirs)
    return [(g.reference, g.duplicates) for g in ours] == [
        (g.reference, g.duplicates) for g in theirs
    ]


def _planted_library(n, n_clusters, seed):
    """Random duration-sorted library with planted clusters of 3 (radius
    60) at shared durations; pad bits masked."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(30, 7200, n))
    starts = rng.choice(n // 4 - 1, n_clusters, replace=False) * 4
    for s in starts:
        for k in (1, 2):
            packed[s + k] = _flip(packed[s], rng, 60)
            durations[s + k] = durations[s]
    paths = [f"/lib/{i:06d}.mp4" for i in range(n)]
    hashes = tvdf.VideoHash.many_from_packed_u32(packed, paths, durations)
    return hashes, {frozenset(paths[s + k] for k in range(3)) for s in starts}, starts


@pytest.fixture(scope="module")
def library():
    return _planted_library(4500, 40, seed=12)


@pytest.mark.parametrize("tolerance", [0.0, 0.35, 0.5])
def test_search_matches_jax_host_and_pallas(library, tolerance):
    hashes, planted, _ = library
    ours = tvdf.search(hashes, tolerance, device="cpu")  # auto: >= 4096
    theirs = jax_hashes(hashes)
    assert same_groups(ours, jvdf.search(theirs, tolerance, backend="host"))
    assert same_groups(ours, jvdf.search(theirs, tolerance, backend="pallas"))
    if tolerance == 0.35:
        assert {frozenset(g.contained_paths()) for g in ours} == planted


@pytest.mark.parametrize("backend", ["device", "host", "naive"])
def test_backends_agree(library, backend):
    hashes, _, _ = library
    sub = hashes[:900]  # the naive loop is slow in Python
    assert same_groups(
        tvdf.search(sub, 0.35, backend=backend, device="cpu"),
        jvdf.search(jax_hashes(sub), 0.35, backend="host"),
    )


def _oracle():
    with open(ORACLE) as f:
        return [tvdf.VideoHash.from_json(v) for v in json.load(f).values()]


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_frozen_real_content_two_groups_of_three(backend):
    hashes = _oracle()
    ours = tvdf.search(hashes, backend=backend, device=torch.device("cpu"))
    theirs = jax_hashes(hashes)
    assert same_groups(ours, jvdf.search(theirs, backend="host"))
    assert same_groups(ours, jvdf.search(theirs, backend="pallas"))
    names = sorted(sorted(os.path.basename(p)[:3] for p in g.contained_paths())
                   for g in ours)
    assert names == [["cat"] * 3, ["dog"] * 3]


def test_search_with_references_matches_jax(library):
    hashes, _, starts = library
    refs = [hashes[s].with_src_path(f"/ref/{k}") for k, s in enumerate(starts[:5])]
    ours = tvdf.search_with_references(refs, hashes, 0.35, device="cpu")
    theirs = jvdf.search_with_references(jax_hashes(refs), jax_hashes(hashes), 0.35)
    assert same_groups(ours, theirs)
    assert len(ours) == 5 and all(len(g.duplicates) == 3 for g in ours)


def test_empty_and_default_tolerance():
    assert tvdf.search([], device="cpu") == []
    hashes = _oracle()
    assert tvdf.search(hashes, device="cpu") == tvdf.search(
        hashes, tvdf.DEFAULT_SEARCH_TOLERANCE, device="cpu"
    )


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        tvdf.search(_oracle(), backend="pallas", device="cpu")


def test_device_library_paths_are_not_ported():
    """The three library methods that raised NotImplementedError before
    the library was ported now work on the Search's device."""
    hashes = _oracle()
    s = Search(hashes, device="cpu")
    assert s.device == torch.device("cpu")
    assert s._ensure_cands_dev() is None  # no library attached
    lib = IncrementalDeviceLibrary("cpu")
    lib.append(np.stack([h.packed_u32() for h in hashes]))
    paths = [h.src_path for h in hashes]
    s.attach_device_library(lib, paths)
    order = [paths.index(e.src_path) for e in s.entries]
    np.testing.assert_array_equal(s._library_order, order)
    np.testing.assert_array_equal(
        s._ensure_cands_dev()[: len(hashes)].numpy().view(np.uint32),
        np.stack([e.packed_u32() for e in s.entries]),
    )
    np.testing.assert_array_equal(
        Search._library_rows(lib, [2, 0]), np.stack([hashes[2].packed_u32(), hashes[0].packed_u32()])
    )
    assert same_groups(
        tvdf.search(hashes, device="cpu", device_library=lib, library_paths=paths),
        jvdf.search(jax_hashes(hashes), backend="host"),
    )


def test_public_surface_matches_jax_package():
    """The same public names, each the port's own class, behaving alike:
    the same packed words, durations and paths, and equal groups."""
    assert tvdf.__all__ == jvdf.__all__
    for name in tvdf.__all__:
        assert hasattr(tvdf, name), name
    for name in ("VideoHash", "VideoHashBatch", "MatchGroup", "Search", "Crop"):
        assert getattr(tvdf, name) is not getattr(jvdf, name), name
    ours = _oracle()
    theirs = jax_hashes(ours)
    assert [type(h) for h in theirs] == [jvdf.VideoHash] * len(ours)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.packed_u32(), b.packed_u32())
        assert (a.src_path, a.duration) == (b.src_path, b.duration)
        assert a.to_json() == b.to_json()
    assert same_groups(tvdf.search(ours, device="cpu"), jvdf.search(theirs))
    g = tvdf.MatchGroup.new_with_reference("r", ["a", "b"])
    assert g.to_json() == jvdf.MatchGroup.new_with_reference("r", ["a", "b"]).to_json()
    assert g.dup_combinations() == [tvdf.MatchGroup("r", ("a",)), tvdf.MatchGroup("r", ("b",))]


# -- VDF_SEARCH_BACKEND: the backend of search(backend="auto") ----------------


@pytest.mark.parametrize("named", ["device", "band", "host", "native", "ring", "naive", "auto"])
def test_env_names_the_backend_of_auto(monkeypatch, named):
    """``search(backend="auto")`` runs the backend that VDF_SEARCH_BACKEND
    names; an explicit backend is not overridden."""
    hashes, planted, _ = _planted_library(300, 6, seed=17)
    seen = []
    real = Search.search_self

    def spy(self, tolerance, backend="auto"):
        seen.append(backend)
        return real(self, tolerance, backend=backend)

    monkeypatch.setattr(Search, "search_self", spy)
    monkeypatch.setenv("VDF_SEARCH_BACKEND", named)
    groups = tvdf.search(hashes, 0.35, device="cpu")
    assert seen == [named]
    assert {frozenset(g.contained_paths()) for g in groups} == planted
    assert tvdf.search(hashes, 0.35, backend="host", device="cpu") == groups
    assert seen == [named, "host"]
    monkeypatch.delenv("VDF_SEARCH_BACKEND")
    assert tvdf.search(hashes, 0.35, device="cpu") == groups
    assert seen[-1] == "auto"


@pytest.mark.parametrize("named", ["pallas", "pallas_split", "", "Device"])
def test_env_naming_a_backend_the_port_lacks_raises(monkeypatch, named):
    hashes, _, _ = _planted_library(40, 2, seed=18)
    monkeypatch.setenv("VDF_SEARCH_BACKEND", named)
    with pytest.raises(ValueError, match="VDF_SEARCH_BACKEND"):
        tvdf.search(hashes, 0.35, device="cpu")
    # only backend="auto" reads the variable
    assert tvdf.search(hashes, 0.35, backend="host", device="cpu")


def test_env_host_gives_the_jax_packages_groups(monkeypatch):
    hashes, planted, _ = _planted_library(400, 8, seed=19)
    monkeypatch.setenv("VDF_SEARCH_BACKEND", "host")
    ours = tvdf.search(hashes, 0.35, device="cpu")
    theirs = jvdf.search(jax_hashes(hashes), 0.35)
    assert same_groups(ours, theirs)
    assert {frozenset(g.contained_paths()) for g in ours} == planted
