"""The port's multi-device layer (``vid_dup_finder_lib_tpu_torch.parallel``)
against the JAX package's, on CPU shards.

A port mesh here is a list of CPU devices, one per shard (the counterpart
of the 8-device virtual CPU mesh ``tests/conftest.py`` gives JAX); every
shard then runs the plain versions of K1, K2 and K3.  The same seeded
NumPy inputs go through both packages, and the results must be equal:
pairs exactly, groups exactly, hashes bit for bit against the port's own
single call and within the hash tests' bound (<= 2 bits in a hash, <= 8
in all) against the JAX package's, the candidate scan's three statistics
exactly.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import vid_dup_finder_lib_tpu as jvdf
import vid_dup_finder_lib_tpu_torch as tvdf
from tests.test_refs_windowed import _make_cands_refs, _refs_problem
from tests.test_torch_search import jax_hashes, port_hashes, same_groups
from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host, windowed_adjacency_device
from vid_dup_finder_lib_tpu.parallel import make_mesh as jax_make_mesh
from vid_dup_finder_lib_tpu.parallel.ring_pallas import banded_adjacency_ring as jax_ring
from vid_dup_finder_lib_tpu.parallel.sharded_search import (
    ring_candidate_scan as jax_ring_candidate_scan,
    sharded_hash_batch as jax_sharded_hash_batch,
)
from vid_dup_finder_lib_tpu_torch import parallel
from vid_dup_finder_lib_tpu_torch.ops import hamming as port_hamming
from vid_dup_finder_lib_tpu_torch.ops import hamming_cuda as hc
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk
from vid_dup_finder_lib_tpu_torch.parallel import mesh as port_mesh
from vid_dup_finder_lib_tpu_torch.parallel import refs_sharded as port_refs_sharded
from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda
from vid_dup_finder_lib_tpu_torch.parallel.mesh import Mesh, make_mesh, run_by_device
from vid_dup_finder_lib_tpu_torch.parallel.refs_sharded import refs_adjacency_sharded
from vid_dup_finder_lib_tpu_torch.parallel.sharded_search import (
    banded_adjacency_ring,
    ring_candidate_scan,
    sharded_hash_batch,
)

port_search = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions' many small products on one thread: beside the
    other test workers, torch's own thread pool per worker oversubscribes
    the host's cores and slows this file tenfold and more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(shards: int) -> Mesh:
    return Mesh([CPU] * shards)


def two_device_mesh(shards: int) -> Mesh:
    """``shards`` CPU shards on two devices in alternation, ``cpu`` and
    ``cpu:0`` (equal as places, distinct as keys), as a mesh of two cards
    holds them: :func:`run_by_device` runs each device's jobs from a
    thread of its own, and blocks are copied between the two."""
    return Mesh([CPU, torch.device("cpu", 0)] * (shards // 2))


@pytest.fixture
def two_threads(monkeypatch):
    """The threads of every :func:`run_by_device` call of the ring and of
    the references search: one list per call, of each job's thread."""
    real = port_mesh.run_by_device
    seen = []

    def recorded(jobs):
        threads = []
        seen.append(threads)
        return real([(dev, lambda fn=fn: threads.append(threading.current_thread()) or fn())
                     for dev, fn in jobs])

    for mod in (ring_cuda, port_refs_sharded):
        monkeypatch.setattr(mod, "run_by_device", recorded)
    return seen


def _bounds(durs: np.ndarray) -> np.ndarray:
    return np.searchsorted(durs, (durs * 1.1).astype(np.int64), side="right")


def _equal(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


# -- the mesh -------------------------------------------------------------------


def test_package_exports_the_jax_names():
    assert parallel.__all__ == jvdf.parallel.__all__


def test_make_mesh_gives_cpu_shards():
    assert make_mesh(device="cpu") == Mesh([CPU])
    mesh = make_mesh(5, device="cpu")
    assert isinstance(mesh, Mesh) and mesh.size == 5 and set(mesh) == {CPU}
    assert mesh.shards_per_device() == {CPU: 5}
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(0, device="cpu")


def test_make_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for CUDA-less hosts")
    for kw in ({}, {"device": "cuda"}, {"n_devices": 2}):
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(**kw)
    with pytest.raises(RuntimeError, match="is_available"):
        Mesh(["cuda:0"] * 4)


def test_make_mesh_takes_the_first_cards_and_raises_past_them(monkeypatch):
    """On CUDA: all visible cards by default, the first ``n_devices``, and
    an error for more than are visible (``mesh.py:13-17``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert list(make_mesh(device="cuda:0")) == cards
    assert list(make_mesh(2, device="cuda:1")) == cards[:2]
    with pytest.raises(ValueError, match="need 4 CUDA devices, have 3"):
        make_mesh(4, device="cuda:0")


def test_run_by_device_runs_distinct_devices_at_once_and_keeps_order():
    """The jobs of one device run in turn in one thread, those of another
    device in another; results come back in job order; a job's exception
    is raised after every thread has ended; one device runs inline."""
    import threading

    mesh = [CPU, torch.device("cpu", 0)] * 3  # two distinct keys
    seen = []
    out = run_by_device([(dev, lambda k=k: seen.append((mesh[k], k, threading.current_thread())) or k * k)
                         for k, dev in enumerate(mesh)])
    assert out == [k * k for k in range(6)]
    threads = {dev: {t for d, _, t in seen if d == dev} for dev in set(mesh)}
    assert all(len(t) == 1 for t in threads.values())
    assert len(set.union(*threads.values())) == 2
    for dev in set(mesh):  # in turn, in mesh order, within a device
        assert [k for d, k, _ in seen if d == dev] == [k for k, d in enumerate(mesh) if d == dev]
    assert run_by_device([(CPU, threading.current_thread)] * 3) == [threading.current_thread()] * 3
    assert run_by_device([]) == []
    with pytest.raises(ZeroDivisionError):
        run_by_device([(CPU, lambda: 1), (torch.device("cpu", 0), lambda: 1 // 0)])


def test_explicit_mesh_may_repeat_a_device():
    mesh = Mesh(["cpu", CPU, "cpu"])
    assert mesh.size == 3 and mesh.shards_per_device() == {CPU: 3}
    assert Mesh(mesh) == mesh
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


# -- the ring -------------------------------------------------------------------


@pytest.fixture(scope="module")
def ring_700():
    """The inputs of tests/test_parallel.py::test_ring_adjacency_matches_host."""
    rng = np.random.default_rng(10)
    n = 700
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    durs = np.sort(rng.integers(50, 200, n))
    return packed, _bounds(durs)


@pytest.mark.parametrize("tol", [350, 480])
def test_ring_matches_the_jax_ring(ring_700, tol):
    packed, bounds = ring_700
    want = jax_ring(packed, bounds, tol, mesh=jax_make_mesh(4))
    got = banded_adjacency_ring(packed, bounds, tol, mesh=cpu_mesh(4))
    assert _equal(got, want) and (tol == 350 or len(want[0]) > 0)
    assert got[0].dtype == got[1].dtype == np.int64


@pytest.fixture(scope="module")
def jax_ring_8(ring_700):
    """The JAX package's ring of ``ring_700`` on its 8 virtual chips, at 480."""
    packed, bounds = ring_700
    return jax_ring(packed, bounds, 480, mesh=jax_make_mesh(8))


@pytest.mark.parametrize("shards", [8, 16])
def test_ring_on_more_shards_matches_the_jax_ring(ring_700, jax_ring_8, shards):
    """The port's ring on 8 and 16 CPU shards (blocks cut at equal work,
    down to one tile of rows) against the JAX package's ring on 8 chips."""
    packed, bounds = ring_700
    got = banded_adjacency_ring(packed, bounds, 480, mesh=cpu_mesh(shards))
    assert _equal(got, jax_ring_8) and len(got[0]) > 0
    assert ring_cuda.LAST_RING_PHASES["shards"] == len(ring_cuda.ring_cuts(bounds, shards)) - 1 > 1


def assert_balanced(work: np.ndarray, cuts: np.ndarray, shards: int) -> None:
    """``cuts`` start non-empty blocks on 128-row tiles (the last ends at
    n), at most ``shards`` of them, and each cut lies where the running
    sum of ``work`` is within one tile's rows of its share: off by no
    more than the work of the 128 rows on either side of it."""
    n = len(work)
    assert cuts[0] == 0 and cuts[-1] == n and (np.diff(cuts) > 0).all()
    assert len(cuts) - 1 <= shards and not (cuts[1:-1] % ring_cuda.TILE).any()
    before = np.concatenate([[0], np.cumsum(work)])
    total = before[-1]
    for c in cuts[1:-1]:
        k = round(before[c] * shards / total)
        near = before[min(c + ring_cuda.TILE, n)] - before[max(c - ring_cuda.TILE, 0)]
        assert abs(before[c] - k * total / shards) <= near
    if n >= shards * ring_cuda.TILE * 4:  # room for every shard: one block each
        assert len(cuts) - 1 == shards


@pytest.mark.parametrize("shards", [2, 4, 8, 16])
@pytest.mark.parametrize("library", ["uniform", "equal durations", "below shards x 128"])
def test_ring_cuts_hold_equal_pairs_within_one_tile(library, shards):
    """The ring's cuts at equal in-band pairs on the bench recipe's uniform
    durations (30-7200 s), on one duration for all (a triangle of pairs),
    and on fewer rows than ``shards`` tiles."""
    rng = np.random.default_rng(shards)
    n = {"uniform": 200_000, "equal durations": 50_000, "below shards x 128": shards * 128 - 77}[library]
    durs = np.sort(rng.integers(30, 7200, n)) if library != "equal durations" else np.full(n, 600)
    bounds = np.minimum(_bounds(durs), n)
    cuts = ring_cuda.ring_cuts(bounds, shards)
    assert_balanced(np.maximum(bounds - np.arange(n), 1), cuts, shards)
    if library == "below shards x 128":
        assert len(cuts) - 1 <= -(-n // ring_cuda.TILE) <= shards


def test_ring_cuts_at_1m_balance_the_pairs_where_equal_rows_do_not():
    """chip_smoke's 1M library (``bench.py``'s recipe): the four blocks hold
    25% of the 4.587e10 in-band pairs each within 0.01 points, at rows
    474,624 / 672,896 / 825,216, where equal row blocks hold 7.0, 20.7,
    34.4 and 37.9%; the per-(shard, step) pairs the ring reports add up."""
    import chip_smoke as cs

    _, durations, _ = cs.planted_library(1_000_000, cs.SEED, n_clusters=0)
    bounds = np.minimum(cs.self_bounds(durations), len(durations))
    cuts = ring_cuda.ring_cuts(bounds, 4)
    assert cuts.tolist() == [0, 474_624, 672_896, 825_216, 1_000_000]
    s_max, _ = ring_cuda._plan(bounds, cuts)
    cum = ring_cuda.ring_work(bounds)
    shares = np.array([sum(ring_cuda._block_pairs(bounds, cum, cuts, d, s) for s in range(last + 1))
                       for d, last in enumerate(s_max)])
    total = int(np.maximum(bounds - np.arange(1, len(bounds) + 1), 0).sum())
    assert shares.sum() == total and abs(total - 4.587e10) < 1e8
    assert np.abs(shares / total - 0.25).max() < 1e-4
    rows = np.minimum(np.arange(5) * 250_112, 1_000_000)
    equal = np.diff(np.concatenate([[0], np.cumsum(np.maximum(bounds - np.arange(1, len(bounds) + 1), 0))])[rows])
    assert np.round(100 * equal / total, 1).tolist() == [7.0, 20.7, 34.4, 37.9]


def test_ring_reports_each_shard_and_step(guard_16k):
    """``LAST_RING_PHASES``: the block starts, each (shard, step)'s
    seconds and in-band pairs (they add up to the band's), and the two
    projected walls on distinct cards."""
    packed, bounds, _ = guard_16k
    banded_adjacency_ring(packed, bounds, 350, mesh=cpu_mesh(8))
    ph = ring_cuda.LAST_RING_PHASES
    n = len(bounds)
    assert ph["cuts"] == ring_cuda.ring_cuts(np.minimum(bounds, n), 8).tolist()
    assert [len(t) for t in ph["shard_s"]] == [len(p) for p in ph["shard_pairs"]]
    assert max(len(t) for t in ph["shard_s"]) == ph["steps"]
    assert sum(map(sum, ph["shard_pairs"])) == np.maximum(np.minimum(bounds, n) - np.arange(1, n + 1), 0).sum()
    per_step = [max(t[s] for t in ph["shard_s"] if s < len(t)) for s in range(ph["steps"])]
    assert ph["projected_wall_s"] == pytest.approx(sum(per_step))
    assert ph["projected_free_s"] == pytest.approx(max(map(sum, ph["shard_s"])))
    assert 0 < ph["projected_free_s"] <= ph["projected_wall_s"] <= ph["sweep"]


def guard_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The inputs of tests/test_parallel.py::test_ring_windowed_and_zero_hash_guard:
    all-zero and all-ones hashes at block edges, whose match with a zero
    pad column would be a phantom pair, and a duplicate pair across a block
    boundary."""
    rng = np.random.default_rng(40)
    n = 16384
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durs = np.sort(rng.integers(1000, 40000, n))
    for row in (2040, 2047, 4095, 6100, 12287):
        packed[row] = 0
    packed[8191] = 0xFFFFFFFF
    packed[8191, -1] = 0xFF
    bounds = _bounds(durs)
    packed[2046] = packed[2050]
    durs[2050] = durs[2046]
    return packed, bounds


@pytest.fixture(scope="module")
def guard_16k():
    """:func:`guard_inputs` with the JAX package's host sweep."""
    packed, bounds = guard_inputs()
    want = banded_adjacency_host(packed, bounds, 350)
    assert len(want[0]) > 0
    return packed, bounds, want


@pytest.mark.parametrize("shards, k_max", [(4, 1), (8, 2), (16, 3)])
def test_ring_matches_the_jax_host_sweep(guard_16k, shards, k_max):
    """Bands that reach into the next block, and with 8 and 16 shards into
    the ones after it (the blocks are cut at equal work, so the last ones,
    whose rows have the widest bands, are the shortest)."""
    packed, bounds, want = guard_16k
    got = banded_adjacency_ring(packed, bounds, 350, mesh=cpu_mesh(shards))
    assert _equal(got, want)
    ph = ring_cuda.LAST_RING_PHASES
    assert (ph["shards"], ph["k_max"], ph["steps"]) == (shards, k_max, k_max + 1)
    # on the CPU no kernel launches; every step moved a block but the last
    assert ph["band_counts"] == ph["band_pack"] == 0
    assert ph["rotated_bytes"] > 0
    assert set(ph) >= {"setup", "sweep", "rotate", "decode"}


def test_ring_swept_from_two_threads_matches_the_jax_host_sweep(guard_16k, two_threads):
    """16 shards on two devices in alternation, as on two cards: every
    (shard, step) of the ring in one call, each device's from a thread of
    its own, with blocks copied between the devices."""
    packed, bounds, want = guard_16k
    got = banded_adjacency_ring(packed, bounds, 350, mesh=two_device_mesh(16), counts_budget=256)
    ph = ring_cuda.LAST_RING_PHASES
    assert _equal(got, want) and len(two_threads) == 1
    assert len(two_threads[0]) == sum(len(t) for t in ph["shard_s"]) > 16
    assert len(set(two_threads[0])) == 2


def test_ring_in_small_slabs_matches_the_jax_host_sweep(guard_16k):
    """A counts budget of 64 cells cuts every (shard, step) into slabs."""
    packed, bounds, want = guard_16k
    got = banded_adjacency_ring(packed, bounds, 350, mesh=cpu_mesh(16), counts_budget=64)
    assert _equal(got, want)


def test_ring_on_a_resident_tensor_matches_the_jax_host_sweep(guard_16k):
    """The library resident as an int32 tensor with ``n`` rows first and
    garbage in its pad rows (an ``IncrementalDeviceLibrary`` buffer)."""
    packed, bounds, want = guard_16k
    n = packed.shape[0] - 100
    resident = torch.full((packed.shape[0] + 128, 32), -1, dtype=torch.int32)
    resident[:n] = torch.from_numpy(packed[:n].view(np.int32))
    got = banded_adjacency_ring(resident, np.minimum(bounds[:n], n), 350, mesh=cpu_mesh(8), n=n)
    keep = want[1] < n
    assert _equal(got, (want[0][keep], want[1][keep]))
    with pytest.raises(ValueError, match="row count"):
        banded_adjacency_ring(resident, bounds[:n], 350, mesh=cpu_mesh(8))


@pytest.mark.parametrize("n, shards", [(0, 4), (5, 8), (200, 8), (700, 1)])
def test_ring_edge_sizes_match_the_jax_host_sweep(ring_700, n, shards):
    """No hashes; fewer hashes than shards (a shard past n owns nothing);
    fewer than one tile per shard; a one-shard mesh."""
    packed, _ = ring_700
    packed = packed[:n].copy()
    if n:
        packed[::3] = packed[0]  # one group of copies at one duration
    bounds = _bounds(np.repeat(100, n))
    got = banded_adjacency_ring(packed, bounds, 350, mesh=cpu_mesh(shards))
    want = banded_adjacency_host(packed, bounds, 350)
    copies = len(range(0, n, 3))
    assert _equal(got, want) and len(got[0]) == copies * (copies - 1) // 2
    owners = len(ring_cuda.ring_cuts(np.minimum(bounds, n), shards)) - 1
    assert ring_cuda.LAST_RING_PHASES["shards"] == owners
    assert owners == {0: 0, 5: 1, 200: 2, 700: 1}[n]


def test_ring_plan_reaches_every_block_of_a_band():
    """Shard d sweeps block d + s for every s up to the block its widest
    row reaches; blocks pass through the shards in between."""
    n = 1000
    bounds = np.minimum(np.arange(n) + 1, n)
    cuts = np.array([0, 128, 256, 384, 512, 640, 768, 896, 1000])
    assert np.array_equal(ring_cuda.ring_cuts(bounds, 8), cuts)  # no pairs: equal rows
    bounds[0] = 400  # row 0 reaches block 3
    s_max, holds = ring_cuda._plan(bounds, cuts)
    assert s_max == [3, 0, 0, 0, 0, 0, 0, 0]
    assert holds.shape == (4, 8)
    assert holds[1, :3].all() and holds[2, :2].all() and holds[3, 0]
    assert holds.sum() == 3 + 2 + 1
    assert ring_cuda.ring_cuts(np.minimum(np.arange(n) + 1, n), 3).tolist() == [0, 384, 640, 1000]


def test_ring_capacity_ok_on_a_cpu_mesh():
    assert ring_cuda.ring_capacity_ok(10**9, np.full(4, 10**9), 4, mesh=cpu_mesh(4))


# -- the public search --------------------------------------------------------


@pytest.fixture(scope="module")
def clustered_10k():
    """The hashes of tests/test_parallel.py::test_ring_search_groups_match_host_10k."""
    rng = np.random.default_rng(11)
    n, n_centers = 10240, 96
    centers = rng.integers(0, 2, (n_centers, 1000)).astype(np.uint8)
    bits = centers[rng.integers(0, n_centers, n)]
    bits = bits ^ (rng.random((n, 1000)) < 0.08)
    durs = np.sort(rng.integers(100, 200, n))
    return [jvdf.VideoHash.from_bits(bits[i], src_path=f"/v/{i:05d}", duration=int(durs[i]))
            for i in range(n)]


@pytest.fixture
def four_cpu_shards(monkeypatch):
    """The default mesh of ``search`` and of the references search: four
    CPU shards instead of one."""
    monkeypatch.setattr(port_mesh, "make_mesh", lambda n_devices=None, device=None: cpu_mesh(4))


def test_ring_search_groups_match_the_jax_host_search(clustered_10k, four_cpu_shards):
    theirs = jvdf.search(clustered_10k, 0.25, backend="host")
    ours = tvdf.search(port_hashes(clustered_10k), 0.25, backend="ring", device="cpu")
    assert ring_cuda.LAST_RING_PHASES["shards"] == 4
    assert len(theirs) > 50 and same_groups(ours, theirs)
    assert ours == tvdf.search(port_hashes(clustered_10k), 0.25, backend="device", device="cpu")


def test_env_names_the_ring(monkeypatch, four_cpu_shards):
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 2**32, (1024, 32), dtype=np.uint64).astype(np.uint32)
    packed[1::2] = packed[::2]
    durs = np.repeat(np.sort(rng.integers(30, 7200, 512)), 2)
    hashes = tvdf.VideoHash.many_from_packed_u32(packed, [f"v{i}" for i in range(1024)], durs)
    monkeypatch.setenv("VDF_SEARCH_BACKEND", "ring")
    ring_cuda.LAST_RING_PHASES = {}
    groups = tvdf.search(hashes, 0.35, device="cpu")
    assert ring_cuda.LAST_RING_PHASES["shards"] == 4  # rows cut at 512, 640 and 896
    assert len(groups) == 512
    assert same_groups(groups, jvdf.search(jax_hashes(hashes), 0.35, backend="host"))


def test_ring_search_over_an_attached_library_takes_the_host_matrix(four_cpu_shards):
    rng = np.random.default_rng(6)
    packed = rng.integers(0, 2**32, (500, 32), dtype=np.uint64).astype(np.uint32)
    packed[1::2] = packed[::2]
    durs = np.repeat(np.sort(rng.integers(30, 7200, 250)), 2)
    paths = [f"v{i}" for i in range(500)]
    hashes = tvdf.VideoHash.many_from_packed_u32(packed, paths, durs)
    lib = hc.IncrementalDeviceLibrary("cpu")
    lib.append(packed[::-1].copy())
    ring_cuda.LAST_RING_PHASES = {}
    got = tvdf.search(hashes, 0.35, backend="ring", device="cpu", device_library=lib,
                      library_paths=paths[::-1])
    assert ring_cuda.LAST_RING_PHASES["shards"] == 3  # rows cut at 256 and 384: 4 shards, 3 blocks
    assert got == tvdf.search(hashes, 0.35, backend="device", device="cpu") and len(got) == 250


@pytest.fixture
def visible_cards(monkeypatch):
    """``auto`` on a card, with ``k`` cards visible: the one-card sweep
    stubbed (it returns ``("one card", device)``), the ring over the CPU
    mesh :func:`two_device_mesh` of 4 shards that ``make_mesh`` now gives."""
    def set_cards(k):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: k)
        monkeypatch.setattr(port_hamming, "resolve_device", lambda device: torch.device("cuda", 0))
        monkeypatch.setattr(port_hamming, "SearchState", lambda packed, bounds, dev: ("one card", dev))
        monkeypatch.setattr(port_hamming, "banded_adjacency_cuda", lambda state, tol: state)
        monkeypatch.setattr(port_mesh, "make_mesh",
                            lambda n_devices=None, device=None: two_device_mesh(4))
    return set_cards


def test_auto_never_takes_the_ring(monkeypatch, visible_cards):
    """``auto`` on a card runs the one-card two-phase sweep at any size
    where one card is visible, and where several are under
    ``VDF_AUTO_RING=0``."""
    monkeypatch.setattr(ring_cuda, "banded_adjacency_ring", lambda *a, **kw: pytest.fail("ring"))
    packed = np.broadcast_to(np.zeros((1, 32), np.uint32), (2 * port_hamming.RING_MIN_N, 32))
    bounds = np.arange(1, packed.shape[0] + 1)
    for cards, auto_ring in ((1, None), (4, "0")):
        visible_cards(cards)
        if auto_ring is not None:
            monkeypatch.setenv("VDF_AUTO_RING", auto_ring)
        got = port_hamming.banded_adjacency(packed, bounds, 350, device="cuda")
        assert got == ("one card", torch.device("cuda", 0))


def small_library(n: int, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """``n`` random hashes in pairs of copies at shared durations, sorted."""
    rng = np.random.default_rng(seed)
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[1::2] = packed[::2][: n // 2]
    durs = np.sort(np.repeat(rng.integers(30, 7200, -(-n // 2)), 2)[:n])
    return packed, _bounds(durs)


@pytest.mark.parametrize("case, takes_ring", [
    ("at the minimum", True), ("above it", True), ("below it", False),
    ("VDF_AUTO_RING=0", False), ("capacity fails", False), ("one card", False),
])
def test_auto_takes_the_ring_on_several_cards_from_the_minimum(
        monkeypatch, visible_cards, case, takes_ring):
    """With 4 cards visible, ``auto`` takes the ring over every card from
    ``VDF_RING_MIN_N`` hashes up while ``VDF_AUTO_RING`` is 1 and
    ``ring_capacity_ok`` passes (``ops/hamming.py:466-499``); its pairs
    are the JAX package's host sweep's."""
    n = 1024
    visible_cards(1 if case == "one card" else 4)
    monkeypatch.setenv("VDF_RING_MIN_N", str({"above it": n - 1, "below it": n + 1}.get(case, n)))
    if case == "VDF_AUTO_RING=0":
        monkeypatch.setenv("VDF_AUTO_RING", "0")
    if case == "capacity fails":
        monkeypatch.setattr(ring_cuda, "ring_capacity_ok", lambda n, bounds, n_dev, mesh=None: False)
    packed, bounds = small_library(n)
    ring_cuda.LAST_RING_PHASES = {}
    got = port_hamming.banded_adjacency(packed, bounds, 350, device="cuda")
    if takes_ring:
        assert _equal(got, banded_adjacency_host(packed, bounds, 350)) and len(got[0]) == n // 2
        assert ring_cuda.LAST_RING_PHASES["shards"] == 4
    else:
        assert got == ("one card", torch.device("cuda", 0)) and not ring_cuda.LAST_RING_PHASES


def test_auto_ring_minimum_defaults_to_the_measured_cut_over(monkeypatch, visible_cards):
    """Unset, ``VDF_RING_MIN_N`` is :data:`RING_MIN_N`."""
    visible_cards(4)
    monkeypatch.delenv("VDF_RING_MIN_N", raising=False)
    monkeypatch.setattr(ring_cuda, "banded_adjacency_ring", lambda *a, **kw: "ring")
    monkeypatch.setattr(ring_cuda, "ring_capacity_ok", lambda n, bounds, n_dev, mesh=None: True)
    for n, want in ((port_hamming.RING_MIN_N - 1, ("one card", torch.device("cuda", 0))),
                    (port_hamming.RING_MIN_N, "ring")):
        packed = np.broadcast_to(np.zeros((1, 32), np.uint32), (n, 32))
        assert port_hamming.banded_adjacency(packed, np.arange(1, n + 1), 350, device="cuda") == want


# -- the references search ----------------------------------------------------


@pytest.fixture(scope="module")
def refs_problem():
    """tests/test_refs_sharded.py's problem and its oracle."""
    rng = np.random.default_rng(11)
    cands, refs, lo, hi = _refs_problem(rng)
    ei, ej = windowed_adjacency_device(refs, cands, lo, hi, 300)
    order = np.lexsort((ej, ei))
    return cands, refs, lo, hi, (ei[order], ej[order])


@pytest.mark.parametrize("shards", [4, 8, 16])
def test_refs_sharded_matches_the_jax_oracle(refs_problem, shards):
    cands, refs, lo, hi, want = refs_problem
    assert len(want[0]) > 300
    got = refs_adjacency_sharded(refs, lo, hi, 300, cands_packed=cands, mesh=cpu_mesh(shards))
    assert _equal(got, want)


@pytest.mark.parametrize("shards", [2, 4, 8, 16])
def test_refs_cuts_hold_equal_window_pairs_within_one_tile(shards):
    """``tools/bench_refs.py``'s recipe, 10,000 references against
    1,000,000 candidates: the references cut at equal window pairs
    ``sum(hi - lo)`` (each reference also counted once)."""
    rng = np.random.default_rng(0)
    cand_durs = np.sort(rng.integers(30, 7200, 1_000_000))
    ref_durs = np.sort(rng.integers(30, 7200, 10_000))
    lo = np.searchsorted(cand_durs, (ref_durs * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(cand_durs, (ref_durs * 1.05).astype(np.int64), "right")
    work = hi - lo + 1
    cuts = ring_cuda.work_cuts(work, shards)
    assert_balanced(work, cuts, shards)
    assert len(cuts) - 1 == shards


def test_refs_sharded_from_two_threads_matches_the_jax_oracle(refs_problem, two_threads):
    cands, refs, lo, hi, want = refs_problem
    got = refs_adjacency_sharded(refs, lo, hi, 300, cands_packed=cands, mesh=two_device_mesh(8))
    blocks = len(ring_cuda.work_cuts(hi - lo + 1, 8)) - 1
    assert _equal(got, want) and len(two_threads) == 1 and len(two_threads[0]) == blocks >= 2
    assert len(set(two_threads[0])) == 2


def test_refs_sharded_over_resident_candidates(refs_problem):
    cands, refs, lo, hi, want = refs_problem
    resident = hc._tiled(cands, CPU)
    got = refs_adjacency_sharded(refs, lo, hi, 300, cands_dev=resident, n_cands=cands.shape[0],
                                 mesh=cpu_mesh(8), counts_budget=16)
    assert _equal(got, want)
    with pytest.raises(ValueError, match="exactly one"):
        refs_adjacency_sharded(refs, lo, hi, 300, mesh=cpu_mesh(2))
    empty = refs_adjacency_sharded(refs[:0], lo[:0], hi[:0], 300, cands_packed=cands,
                                   mesh=cpu_mesh(2))
    assert empty[0].shape == empty[1].shape == (0,)


@pytest.mark.parametrize("sharded", ["1", "0", None])
def test_search_with_references_sharded_matches_the_jax_loop(monkeypatch, four_cpu_shards, sharded):
    """``VDF_REFS_SHARDED=1`` takes the sharded sweep; ``0`` never does,
    nor does the variable unset, also where several cards are visible; all
    equal the JAX package's per-reference loop (``:71-91``)."""
    if sharded is None:
        monkeypatch.delenv("VDF_REFS_SHARDED", raising=False)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    else:
        monkeypatch.setenv("VDF_REFS_SHARDED", sharded)
    monkeypatch.setenv("VDF_REFS_NATIVE", "0")
    calls = []
    real = port_refs_sharded.refs_adjacency_sharded
    monkeypatch.setattr(port_refs_sharded, "refs_adjacency_sharded",
                        lambda *a, **kw: calls.append(kw["mesh"]) or real(*a, **kw))
    rng = np.random.default_rng(41)
    cands, refs = _make_cands_refs(rng)
    expected = [jvdf.Search(cands).search_with_references([r], 0.47, consume=False)[0]
                for r in refs]
    got = port_search.Search(port_hashes(cands), device="cpu").search_with_references_batched(
        port_hashes(refs), 0.47)
    assert got == expected and any(expected)
    assert calls == ([cpu_mesh(4)] if sharded == "1" else [])


# -- the sharded hash and the candidate scan --------------------------------------


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_hash_matches_the_single_call_and_the_jax_package(shards):
    rng = np.random.default_rng(0)
    cubes = rng.integers(0, 256, (19, 16, 16, 16), dtype=np.uint8)
    got = sharded_hash_batch(cpu_mesh(shards), cubes)
    single = hk.hash_cubes(torch.from_numpy(cubes)).numpy().view(np.uint32)
    assert got.dtype == np.uint32 and np.array_equal(got, single)
    theirs = jax_sharded_hash_batch(jax_make_mesh(8), cubes)
    d = np.bitwise_count(got ^ theirs).sum(axis=1)
    assert d.max() <= 2 and d.sum() <= 8, (d.max(), d.sum())


def test_sharded_hash_of_fewer_cubes_than_shards():
    rng = np.random.default_rng(1)
    cubes = rng.integers(0, 256, (3, 16, 16, 16), dtype=np.uint8)
    single = hk.hash_cubes(torch.from_numpy(cubes)).numpy().view(np.uint32)
    assert np.array_equal(sharded_hash_batch(cpu_mesh(8), torch.from_numpy(cubes)), single)
    assert sharded_hash_batch(cpu_mesh(8), cubes[:0]).shape == (0, 32)
    with pytest.raises(ValueError, match="uint8"):
        sharded_hash_batch(cpu_mesh(2), cubes.astype(np.int16))


def scan_reference(packed, durs, tol):
    """Counts, best distance and smallest best index by brute force, the
    duration threshold in float32 as the JAX package's scan takes it."""
    n = packed.shape[0]
    dist = np.bitwise_count(packed[:, None, :] ^ packed[None, :, :]).sum(axis=2)
    thresh = (durs.astype(np.float32) * np.float32(1.1)).astype(np.int64)
    jj = np.arange(n)
    valid = (jj[None, :] > jj[:, None]) & (durs[None, :] <= thresh[:, None]) & (dist <= tol)
    masked = np.where(valid, dist, 1001)
    best = masked.min(axis=1)
    idx = np.where(valid.any(axis=1), masked.argmin(axis=1), -1)
    return valid.sum(axis=1), best, idx


def test_ring_candidate_scan_matches_the_jax_scan():
    """The inputs of tests/test_parallel.py::test_ring_candidate_scan_matches_host,
    on 8 shards in both packages."""
    rng = np.random.default_rng(1)
    n = 64
    hashes = [jvdf.VideoHash.random_hash(rng) for _ in range(n)]
    durs = np.sort(rng.integers(10, 100, n)).astype(np.int64)
    packed = np.stack([h.packed_u32() for h in hashes])
    theirs = jax_ring_candidate_scan(jax_make_mesh(8), packed, durs, 470)
    ours = ring_candidate_scan(cpu_mesh(8), packed, durs, 470)
    want = scan_reference(packed, durs, 470)
    assert want[0].sum() > 0
    for a, b, c in zip(ours, theirs, want):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_ring_candidate_scan_pads_never_count():
    """The inputs of tests/test_review_fixes.py::test_ring_scan_pads_never_count:
    n not a multiple of the shards, and a near-dark hash that a zero pad
    row would match."""
    rng = np.random.default_rng(7)
    n = 100
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    packed[50] = 0
    for w in rng.choice(31, 8, replace=False):
        packed[50, w] = np.uint32(0xFF)
    durs = np.sort(rng.integers(50, 60, n))
    ours = ring_candidate_scan(cpu_mesh(8), packed, durs, 300)
    theirs = jax_ring_candidate_scan(jax_make_mesh(8), packed, durs, 300)
    assert ours[2].max() < n
    for a, b, c in zip(ours, theirs, scan_reference(packed, durs, 300)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_ring_candidate_scan_ties_across_blocks_take_the_smallest_j():
    """A row with the same best distance in three blocks: the port keeps
    the smallest j on every mesh, where the JAX package keeps the j of the
    block it meets first after the row's own, the highest (its blocks
    rotate forward), so its answer depends on the mesh (ROADMAP.md §3)."""
    rng = np.random.default_rng(3)
    n = 64
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(np.uint32)
    packed[:, -1] &= np.uint32(0xFF)
    durs = np.full(n, 100, np.int64)
    twin = packed[2].copy()
    twin[0] ^= np.uint32(0b111)  # 3 bits from row 2
    for j in (20, 40, 60):  # in blocks 2, 5 and 7 of 8 (8 rows each)
        packed[j] = twin
    want = scan_reference(packed, durs, 100)
    assert want[1][2] == 3 and want[2][2] == 20
    for shards in (2, 4, 8):
        ours = ring_candidate_scan(cpu_mesh(shards), packed, durs, 100)
        for a, c in zip(ours, want):
            assert np.array_equal(a, c)
    theirs = jax_ring_candidate_scan(jax_make_mesh(8), packed, durs, 100)
    assert np.array_equal(theirs[0], want[0]) and np.array_equal(theirs[1], want[1])
    assert theirs[2][2] == 60
