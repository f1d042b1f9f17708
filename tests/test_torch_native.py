"""The port's native host runtime (``vid_dup_finder_lib_tpu_torch.native``,
built by g++ from ``native_src/vdf_native.cpp``) against the JAX package's,
against the NumPy host sweep and against the port's plain two-phase sweep;
the ``native`` backend and the CPU ``auto`` choice of ``search`` against
``vid_dup_finder_lib_tpu.search(backend="native")``; ``search_one`` and the
batched references search with and without ``VDF_REFS_NATIVE=0``; what
happens without a compiler; and two processes building at once.

Inputs are made with NumPy from a seed.  Everything is integers: pairs,
distances, counts and groups are held exactly, pairs in lexicographic order.
"""

import functools
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_torch_hamming import _flip, _library
from tests.test_torch_refs import CASES, _brute_force
from tests.test_torch_search import _planted_library, jax_hashes, same_groups
from vid_dup_finder_lib_tpu import native as jnative
from vid_dup_finder_lib_tpu.ops import hamming as jhamming
from vid_dup_finder_lib_tpu_torch import native
from vid_dup_finder_lib_tpu_torch.ops import hamming as thamming
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["random900", "dense300", "pad_bits", "ragged130", "single", "empty"]


def _u64(packed):
    return np.ascontiguousarray(packed, dtype=np.uint32).view(np.uint64).reshape(-1, 16)


def _same_pairs(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_the_library_builds_here():
    """This host has g++, so the tests below run the native code and not a
    stand-in."""
    assert native.available() and native.get_lib() is not None
    assert jnative.available()


@pytest.mark.parametrize("tol", [0, 350, 1100])
@pytest.mark.parametrize("name", NAMES)
def test_banded_native_matches_jax_native_host_and_the_plain_sweep(name, tol):
    packed, bounds = _library(name)
    got = native.banded_adjacency_native(_u64(packed), bounds, tol)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    _same_pairs(got, jnative.banded_adjacency_native(_u64(packed), bounds, tol))
    _same_pairs(got, jhamming.banded_adjacency_host(packed, bounds, tol))
    _same_pairs(got, thamming.banded_adjacency_host(packed, bounds, tol))
    _same_pairs(got, hc.banded_adjacency_plain(hc.SearchState(packed, bounds, CPU), tol))
    _same_pairs(got, thamming.banded_adjacency(packed, bounds, tol, backend="native"))
    order = np.lexsort((got[1], got[0]))
    assert (order == np.arange(len(order))).all()  # lexicographic
    for threads in (1, 3):
        _same_pairs(got, native.banded_adjacency_native(_u64(packed), bounds, tol, threads))


def test_banded_native_grows_its_pair_buffer():
    """More pairs than the first buffer of 65,536 holds: a second call with
    the exact capacity, the same pairs."""
    rng = np.random.default_rng(3)
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    packed = np.stack([_flip(seed, rng, 20) for _ in range(400)])
    bounds = np.full(400, 400)
    got = native.banded_adjacency_native(_u64(packed), bounds, 350)
    assert len(got[0]) == 400 * 399 // 2 > 1 << 16
    _same_pairs(got, thamming.banded_adjacency_host(packed, bounds, 350))


@pytest.mark.parametrize("tol", [0, 350, 470, 1100])
@pytest.mark.parametrize("case", list(CASES))
def test_refs_windowed_native_matches_jax_native_bruteforce_and_plain(case, tol):
    refs, cands, lo, hi = CASES[case]()
    got = native.refs_windowed_native(_u64(refs), _u64(cands), lo, hi, tol)
    assert got[0].dtype == np.int64 and got[1].dtype == np.int64
    _same_pairs(got, jnative.refs_windowed_native(_u64(refs), _u64(cands), lo, hi, tol))
    assert list(zip(got[0].tolist(), got[1].tolist())) == _brute_force(refs, cands, lo, hi, tol)
    _same_pairs(got, hc.refs_adjacency_plain(hc.RefsState(refs, cands, lo, hi, CPU), tol))


@pytest.mark.parametrize("name", ["random900", "pad_bits", "single"])
def test_distances_and_count_match_jax_native_and_numpy(name):
    packed, bounds = _library(name)
    target = packed[len(packed) // 2]
    got = native.distances_one_native(target, packed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jnative.distances_one_native(target, packed))
    np.testing.assert_array_equal(got, np.bitwise_count(packed ^ target[None]).sum(1))
    np.testing.assert_array_equal(got, thamming.hamming_matrix_host(target[None], packed)[0])
    np.testing.assert_array_equal(
        thamming.hamming_matrix_host(packed[:50], packed[:70]),
        jhamming.hamming_matrix_host(packed[:50], packed[:70]))
    for tol in (0, 350, 1100):
        count = native.count_leq_native(_u64(packed), bounds, tol)
        assert count == jnative.count_leq_native(_u64(packed), bounds, tol)
        assert count == len(thamming.banded_adjacency_host(packed, bounds, tol)[0])
        assert count == native.count_leq_native(_u64(packed), bounds, tol, n_threads=4)


# -- the public search ---------------------------------------------------------


@pytest.fixture(scope="module")
def library():
    return _planted_library(4500, 40, seed=51)


@pytest.fixture
def sweeps(monkeypatch):
    """Which sweep ran: calls of the native banded sweep, the native
    windowed sweep and the plain phase A."""
    seen = {"native": 0, "refs_native": 0, "plain": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(native, "banded_adjacency_native",
                        counted("native", native.banded_adjacency_native))
    monkeypatch.setattr(native, "refs_windowed_native",
                        counted("refs_native", native.refs_windowed_native))
    monkeypatch.setattr(hc, "band_counts_plain", counted("plain", hc.band_counts_plain))
    return seen


@functools.lru_cache(maxsize=None)
def _expected_groups(tolerance):
    """The 4,500-hash library's groups at ``tolerance`` from the JAX
    package's native backend (equal to its host backend's) and from the
    port's plain two-phase sweep."""
    hashes, _, _ = _planted_library(4500, 40, seed=51)
    theirs = jax_hashes(hashes)
    jax_native = jvdf.search(theirs, tolerance, backend="native")
    assert jax_native == jvdf.search(theirs, tolerance, backend="host")
    return jax_native, tvdf.search(hashes, tolerance, backend="device", device="cpu")


@pytest.mark.parametrize("tolerance", [0.0, 0.35, 0.5])
@pytest.mark.parametrize("backend", ["native", "auto"])
def test_search_native_and_cpu_auto_match_jax_native(library, sweeps, backend, tolerance):
    """4,500 hashes: ``auto`` on the CPU takes the native sweep, as the JAX
    package does on a host without an accelerator; the groups are the JAX
    package's, in its order, and the plain two-phase sweep's."""
    hashes, planted, _ = library
    ours = tvdf.search(hashes, tolerance, backend=backend, device="cpu")
    assert sweeps == {"native": 1, "refs_native": 0, "plain": 0}
    jax_native, port_device = _expected_groups(tolerance)
    assert same_groups(ours, jax_native)
    assert ours == port_device
    if tolerance == 0.35:
        assert {frozenset(g.contained_paths()) for g in ours} == planted


def test_native_backend_sweeps_small_libraries_too(sweeps):
    hashes, planted, _ = _planted_library(300, 6, seed=52)
    ours = tvdf.search(hashes, 0.35, backend="native", device="cpu")
    assert sweeps["native"] == 1
    assert {frozenset(g.contained_paths()) for g in ours} == planted
    assert same_groups(ours, jvdf.search(jax_hashes(hashes), 0.35, backend="native"))
    tvdf.search(hashes, 0.35, device="cpu")  # auto below 4096: the pairwise loop
    assert sweeps == {"native": 1, "refs_native": 0, "plain": 0}


def test_cpu_auto_without_the_library_runs_the_plain_sweep(library, sweeps, monkeypatch):
    hashes, planted, _ = library
    monkeypatch.setattr(native, "available", lambda: False)
    ours = tvdf.search(hashes, 0.35, device="cpu")
    assert sweeps["native"] == 0 and sweeps["plain"] >= 1
    assert {frozenset(g.contained_paths()) for g in ours} == planted


def test_a_resident_library_keeps_to_the_device_sweep(sweeps):
    """``auto`` over an attached library sweeps its resident rows, on the
    CPU too; ``native`` sweeps the host matrix."""
    hashes, planted, _ = _planted_library(600, 8, seed=53)
    lib = hc.IncrementalDeviceLibrary("cpu")
    lib.append(np.stack([h.packed_u32() for h in hashes]))
    paths = [h.src_path for h in hashes]
    ours = tvdf.search(hashes, 0.35, device="cpu", device_library=lib, library_paths=paths)
    assert sweeps["native"] == 0 and sweeps["plain"] >= 1
    assert ours == tvdf.search(hashes, 0.35, backend="native", device="cpu",
                               device_library=lib, library_paths=paths)
    assert sweeps["native"] == 1
    assert {frozenset(g.contained_paths()) for g in ours} == planted


def test_auto_on_a_card_never_takes_the_native_sweep(sweeps):
    """Asking for the card on a host without one raises; it does not run
    the host's native sweep instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for CUDA-less hosts")
    packed, bounds = _library("random900")
    with pytest.raises(RuntimeError, match="is_available"):
        thamming.banded_adjacency(packed, bounds, 350, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        thamming.banded_adjacency(packed, bounds, 350)
    assert sweeps["native"] == 0


# -- the references search -----------------------------------------------------


@pytest.fixture(scope="module")
def refs_library():
    hashes, _, starts = _planted_library(1000, 24, seed=54)
    rng = np.random.default_rng(55)
    refs = [
        tvdf.VideoHash.from_packed_u32(_flip(hashes[s].packed_u32(), rng, 40))
        .with_src_path(f"/ref/p{k}").with_duration(hashes[s].duration)
        for k, s in enumerate(starts)
    ]
    refs += [
        tvdf.VideoHash.random_hash(rng).with_src_path(f"/ref/r{k}")
        .with_duration(int(rng.integers(30, 7200)))
        for k in range(90)
    ]
    order = rng.permutation(len(refs))
    return hashes, [refs[k] for k in order]


@pytest.mark.parametrize("refs_native", [None, "1", "0"])
def test_batched_refs_with_and_without_the_native_sweep(
        refs_library, sweeps, monkeypatch, refs_native):
    hashes, refs = refs_library
    if refs_native is None:
        monkeypatch.delenv("VDF_REFS_NATIVE", raising=False)
    else:
        monkeypatch.setenv("VDF_REFS_NATIVE", refs_native)
    s = tvdf.Search(hashes, device=CPU)
    got = s.search_with_references_batched(refs, 0.35)
    took_native = refs_native != "0"
    assert sweeps["refs_native"] == int(took_native)
    assert (sweeps["plain"] > 0) == (not took_native)
    assert got == [s.search_one(r, 0.35, consume=False) for r in refs]
    assert got == jvdf.Search(jax_hashes(hashes)).search_with_references_batched(
        jax_hashes(refs), 0.35)
    assert sum(map(len, got)) >= 3 * 24
    ours = tvdf.search_with_references(refs, hashes, 0.35, device=CPU)
    assert same_groups(
        ours, jvdf.search_with_references(jax_hashes(refs), jax_hashes(hashes), 0.35))
    assert sorted(g.reference for g in ours) == sorted(f"/ref/p{k}" for k in range(24))


def test_batched_refs_over_a_resident_library_keep_to_the_device_sweep(refs_library, sweeps):
    hashes, refs = refs_library
    lib = hc.IncrementalDeviceLibrary("cpu")
    lib.append(np.stack([h.packed_u32() for h in hashes]))
    s = tvdf.Search(hashes, device=CPU)
    s.attach_device_library(lib, [h.src_path for h in hashes])
    got = s.search_with_references_batched(refs, 0.35)
    assert sweeps["refs_native"] == 0 and sweeps["plain"] > 0
    assert got == tvdf.Search(hashes, device=CPU).search_with_references_batched(refs, 0.35)
    assert sweeps["refs_native"] == 1


@pytest.mark.parametrize("with_native", [True, False])
def test_search_one_with_and_without_the_native_distances(
        refs_library, monkeypatch, with_native):
    hashes, refs = refs_library
    calls = []
    real = native.distances_one_native
    monkeypatch.setattr(native, "distances_one_native",
                        lambda *a: calls.append(1) or real(*a))
    if not with_native:
        monkeypatch.setattr(native, "available", lambda: False)
    ours, theirs = tvdf.Search(hashes, device=CPU), jvdf.Search(jax_hashes(hashes))
    for consume in (False, True):
        got = [ours.search_one(r, 0.35, consume) for r in refs[:30]]
        assert got == [theirs.search_one(r, 0.35, consume) for r in jax_hashes(refs[:30])]
    assert bool(calls) == with_native
    assert ours.matched.any()


# -- without a compiler, and two processes building at once ---------------------


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """A process that has not built the library yet, an empty cache and no
    g++ on the PATH."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv("VDF_NATIVE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    return tmp_path / "cache"


def test_native_backend_raises_when_the_build_fails(no_compiler):
    packed, bounds = _library("random900")
    assert not native.available()
    with pytest.raises(RuntimeError, match="backend='native'.*could not be built"):
        thamming.banded_adjacency(packed, bounds, 350, backend="native", device="cpu")
    hashes, _, _ = _planted_library(300, 6, seed=56)
    with pytest.raises(RuntimeError, match="backend='native'"):
        tvdf.search(hashes, 0.35, backend="native", device="cpu")
    assert glob.glob(str(no_compiler / "*")) == []  # nothing half-written is left


def test_without_a_compiler_auto_and_the_references_search_run_plain(no_compiler):
    hashes, planted, starts = _planted_library(4200, 12, seed=57)
    ours = tvdf.search(hashes, 0.35, device="cpu")
    assert {frozenset(g.contained_paths()) for g in ours} == planted
    refs = [hashes[s].with_src_path(f"/ref/{k}") for k, s in enumerate(starts)] * 6
    found = tvdf.search_with_references(refs, hashes, 0.35, device="cpu")
    assert len(refs) >= 64 and len(found) == len(refs)
    s = tvdf.Search(hashes, device=CPU)
    assert len(s.search_one(refs[0], 0.35, consume=False)) == 3
    assert not native.available()


def test_default_cache_is_in_the_checkout_when_writable(monkeypatch, tmp_path):
    in_checkout = os.path.join(REPO, "build", "vdf_torch_native")
    assert native._default_cache_dir() == in_checkout
    assert os.path.dirname(native.get_lib()._name) == in_checkout
    monkeypatch.setattr(native.os, "access", lambda *a: False)
    assert native._default_cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "vdf_native")
    monkeypatch.undo()

    def refuse(*a, **kw):
        raise PermissionError("read-only checkout")

    monkeypatch.setattr(native.os, "makedirs", refuse)
    assert native._default_cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "vdf_native")


_BUILD_AND_SWEEP = """
    import sys
    import numpy as np
    from vid_dup_finder_lib_tpu_torch import native
    assert native.available(), "the build failed"
    packed = np.arange(64 * 16, dtype=np.uint64).reshape(64, 16)
    packed[1] = packed[0]
    i, j = native.banded_adjacency_native(packed, np.full(64, 64), 0)
    assert (i.tolist(), j.tolist()) == ([0], [1])
    print(native.get_lib()._name)
"""


def test_two_processes_build_into_one_empty_cache(tmp_path):
    """Each compiles to a temporary file of its own and renames it into
    place: both load a whole library, one file remains, no leftovers."""
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHONPATH")}
    env["VDF_NATIVE_CACHE"] = str(cache)
    procs = [
        subprocess.Popen([sys.executable, "-c", textwrap.dedent(_BUILD_AND_SWEEP)], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    libs = sorted(os.listdir(cache))
    assert len(libs) == 1 and libs[0].startswith("libvdf_native_") and libs[0].endswith(".so")
    assert {out.strip() for out, _ in outs} == {str(cache / libs[0])}
