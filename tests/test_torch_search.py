"""The port's public search (``vid_dup_finder_lib_tpu_torch.search``) against
the JAX package's ``search`` on its host and Pallas backends.

Groups are held exactly: the same MatchGroups in the same order.  The port
computes the adjacency with the plain versions of its kernels here (CPU
tensors); the greedy replay is the JAX package's own code.
"""

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
    assert ours == jvdf.search(hashes, tolerance, backend="host")
    assert ours == jvdf.search(hashes, tolerance, backend="pallas")
    if tolerance == 0.35:
        assert {frozenset(g.contained_paths()) for g in ours} == planted


@pytest.mark.parametrize("backend", ["device", "host", "naive"])
def test_backends_agree(library, backend):
    hashes, _, _ = library
    sub = hashes[:900]  # the naive loop is slow in Python
    assert tvdf.search(sub, 0.35, backend=backend, device="cpu") == jvdf.search(
        sub, 0.35, backend="host"
    )


def _oracle():
    with open(ORACLE) as f:
        return [tvdf.VideoHash.from_json(v) for v in json.load(f).values()]


@pytest.mark.parametrize("backend", ["auto", "device"])
def test_frozen_real_content_two_groups_of_three(backend):
    hashes = _oracle()
    ours = tvdf.search(hashes, backend=backend, device=torch.device("cpu"))
    assert ours == jvdf.search(hashes, backend="host")
    assert ours == jvdf.search(hashes, backend="pallas")
    names = sorted(sorted(os.path.basename(p)[:3] for p in g.contained_paths())
                   for g in ours)
    assert names == [["cat"] * 3, ["dog"] * 3]


def test_search_with_references_matches_jax(library):
    hashes, _, starts = library
    refs = [hashes[s].with_src_path(f"/ref/{k}") for k, s in enumerate(starts[:5])]
    ours = tvdf.search_with_references(refs, hashes, 0.35)
    assert ours == jvdf.search_with_references(refs, hashes, 0.35)
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
    assert tvdf.search(hashes, device="cpu", device_library=lib, library_paths=paths) == (
        jvdf.search(hashes, backend="host")
    )


def test_public_surface_matches_jax_package():
    assert tvdf.__all__ == jvdf.__all__
    for name in tvdf.__all__:
        assert hasattr(tvdf, name), name
    assert tvdf.VideoHash is jvdf.VideoHash  # re-exported, not copied
    assert tvdf.MatchGroup is jvdf.MatchGroup
