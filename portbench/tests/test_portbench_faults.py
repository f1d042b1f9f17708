"""The comparison that decides ``correct`` fails what it has to fail: the
control (the reference over 992 of the 1000 bits), and a run of the
harness with the timed path broken underneath it, once for each fault a
self-search can have.  On the CPU, at a size a test holds; the control's
readings at the cells' own sizes come from ``portbench/control.py`` on the
card."""

import importlib
import time

import numpy as np
import pytest

from conftest import SMALL_HASHES
from portbench import control, harness, library

from vid_dup_finder_lib_tpu_torch.match_group import MatchGroup
from vid_dup_finder_lib_tpu_torch.ops import hamming as port_hamming
from vid_dup_finder_lib_tpu_torch.parallel import mesh as port_mesh
from vid_dup_finder_lib_tpu_torch.parallel import ring_cuda

# the module, which the package's own ``search`` function shadows
port_search = importlib.import_module("vid_dup_finder_lib_tpu_torch.search")

SEED = 2**31 + 31


@pytest.mark.parametrize("seed", [1, 2**31 + 2, 3])
def test_the_control_is_not_correct(seed):
    reg = harness.Registry()
    cfg = dict(reg.config("library_8m"), hashes=SMALL_HASHES)
    got = control.control_readings(cfg, seed, "cpu")
    assert got["control_correct"] is False
    # nearly every pair planted one bit outside reads inside over 992 bits
    assert got["checks"]["groups_differing"]["value"] >= 20
    assert got["checks"]["planted_groups_missing"]["value"] == 0


def run(bench_copy):
    line, _ = harness.run_cell(harness.Registry(bench_copy), "small", SEED, 0.5, False,
                               time.perf_counter(), device="cpu", check_chip=False)
    return line


def empty():
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


def test_sound_run_is_correct(bench_copy):
    assert run(bench_copy)["correct"] is True


def test_sweep_returning_nothing(bench_copy, monkeypatch):
    """A sweep that leaves its state as it found it: no pairs."""
    monkeypatch.setattr(port_search, "banded_adjacency", lambda *a, **k: empty())
    line = run(bench_copy)
    assert line["correct"] is False and line["failed"] == line["attempted"]


def test_half_the_library_left_out(bench_copy, monkeypatch):
    real = port_search.banded_adjacency

    def half(packed, bounds, tol, **kw):
        n = len(bounds)
        rows = np.arange(n)
        cut = np.where(rows < n // 2, np.minimum(bounds, n // 2), rows + 1)
        return real(packed, cut, tol, **kw)

    monkeypatch.setattr(port_search, "banded_adjacency", half)
    assert run(bench_copy)["correct"] is False


def two_cpu_shards(monkeypatch):
    """``auto`` over a ring of two CPU shards, as it runs over two cards."""
    monkeypatch.setattr(port_hamming, "_auto_ring", lambda n, bounds, dev: True)
    monkeypatch.setattr(port_mesh, "make_mesh",
                        lambda n_devices=None, device=None: port_mesh.Mesh(["cpu", "cpu"]))


def test_ring_without_its_exchange(bench_copy, monkeypatch):
    reg = harness.Registry(bench_copy)
    cfg = reg.config("library_small")
    lib = library.make_library(cfg, SEED)
    bounds = library.self_bounds(lib.durations, cfg["window_factor"])
    cut = int(ring_cuda.ring_cuts(np.minimum(bounds, lib.n), 2)[1])
    # planted groups across the cut: only the exchange between the shards finds them
    assert any(min(g) < cut <= max(g) for g in lib.planted)
    two_cpu_shards(monkeypatch)
    assert run(bench_copy)["correct"] is True
    monkeypatch.setattr(ring_cuda.hc, "refs_adjacency_cuda", lambda *a, **k: empty())
    assert run(bench_copy)["correct"] is False


def test_an_answer_altered(bench_copy, monkeypatch):
    real = port_search._groups

    def altered(matches):
        groups = real(matches)
        g = groups[0]
        groups[0] = MatchGroup(g.reference, g.duplicates[:-1] + ("/library/elsewhere.mp4",))
        return groups

    monkeypatch.setattr(port_search, "_groups", altered)
    line = run(bench_copy)
    assert line["correct"] is False and line["checks"]["groups_differing"]["value"] == 2
