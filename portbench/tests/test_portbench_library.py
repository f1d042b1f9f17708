"""The library recipe: its in-band pairs, and its planted pairs one bit
inside and one bit outside the tolerance and one second inside and
outside the window."""

import json

import numpy as np
import pytest

from conftest import ROOT
from portbench import library


def config(name="library_8m", **changes):
    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    cfg.update(changes)
    return cfg


def distance(a, b) -> int:
    return int(np.bitwise_count(a ^ b).sum())


def expected_pairs(n: int, cfg: dict) -> float:
    """In-band pairs expected of ``n`` durations drawn by the recipe: the
    chance of each whole second from the truncated exponential's CDF, and
    a pair counts once when the later duration lies in the earlier's
    window."""
    lo, hi = cfg["duration_min_s"], cfg["duration_max_s"]
    scale = library.exponential_scale(lo, hi, cfg["duration_mean_s"] + 0.5)
    d = np.arange(lo, hi)
    cdf = -np.expm1(-(np.arange(lo, hi + 1) - lo) / scale) / -np.expm1(-(hi - lo) / scale)
    p = np.diff(cdf)
    end = np.minimum(library.window_ends(d, cfg["window_factor"]), hi - 1)
    later = np.array([p[k + 1 : e - lo + 1].sum() for k, e in enumerate(end)])
    return n * (n - 1) / 2 * float(np.sum(p * (p + 2 * later)))


def test_in_band_pairs_at_the_corpus_size():
    cfg = config()
    assert cfg["hashes"] == 8_264_650
    assert expected_pairs(cfg["hashes"], cfg) == pytest.approx(5.278e12, rel=2e-3)
    small = config(hashes=1_000_000)
    lib = library.make_library(small, 2**31 + 3)
    pairs = library.band_pairs(library.self_bounds(lib.durations, cfg["window_factor"]))
    assert pairs == pytest.approx(expected_pairs(1_000_000, cfg), rel=5e-3)


def test_durations_keep_the_published_range_and_mean():
    cfg = config()
    d = library.draw_durations(np.random.default_rng(2**31 + 5), cfg, 1_000_000)
    assert d.min() == cfg["duration_min_s"] and d.max() == cfg["duration_max_s"] - 1
    assert (np.diff(d) >= 0).all()
    assert d.mean() == pytest.approx(cfg["duration_mean_s"], abs=0.5)
    # 500K hours over 8,264,650 videos
    assert cfg["duration_mean_s"] == pytest.approx(500_000 * 3600 / cfg["hashes"], abs=1e-3)


@pytest.fixture(scope="module")
def small():
    cfg = config(hashes=30000)
    return cfg, library.make_library(cfg, 7)


def test_shape_order_and_pad_bits(small):
    cfg, lib = small
    assert lib.packed.shape == (30000, 32) and lib.packed.dtype == np.uint32
    assert (lib.packed[:, -1] >> 8 == 0).all()
    assert (np.diff(lib.durations) >= 0).all()
    assert lib.durations.min() >= cfg["duration_min_s"]
    assert lib.durations.max() < cfg["duration_max_s"]
    assert lib.paths()[:2] == ["/library/v00000000.mp4", "/library/v00000001.mp4"]
    assert (lib.paths_bytes[1:] > lib.paths_bytes[:-1]).all()


def test_same_seed_same_library_and_seeds_differ():
    cfg = config(hashes=5000, clusters=20, boundary_pairs=4, edge_pairs=4)
    a, b = library.make_library(cfg, 2**31 + 99), library.make_library(cfg, 2**31 + 99)
    c = library.make_library(cfg, 2**31 + 100)
    assert np.array_equal(a.packed, b.packed) and np.array_equal(a.durations, b.durations)
    assert a.planted == b.planted
    assert not np.array_equal(a.packed, c.packed)


def test_boundary_pairs_lie_one_bit_either_side(small):
    cfg, lib = small
    thr = library.threshold(cfg)
    assert thr == 350
    inside = [g for g in lib.planted if len(g) == 2 and lib.durations[g[0]] == lib.durations[g[1]]]
    outside = [p for p in lib.planted_apart if lib.durations[p[0]] == lib.durations[p[1]]]
    assert len(inside) == len(outside) == cfg["boundary_pairs"]
    assert {distance(lib.packed[a], lib.packed[b]) for a, b in inside} == {thr}
    assert {distance(lib.packed[a], lib.packed[b]) for a, b in outside} == {thr + 1}


def test_edge_pairs_lie_one_second_either_side(small):
    cfg, lib = small
    bounds = library.self_bounds(lib.durations, cfg["window_factor"])
    ends = library.window_ends(lib.durations, cfg["window_factor"])
    inside = [(g[1], g[0]) for g in lib.planted
              if len(g) == 2 and lib.durations[g[0]] != lib.durations[g[1]]]
    outside = [p for p in lib.planted_apart if lib.durations[p[0]] != lib.durations[p[1]]]
    assert len(inside) == len(outside) == cfg["edge_pairs"]
    for base, copy in inside:
        assert lib.durations[copy] == ends[base] and base < copy < bounds[base]
        assert distance(lib.packed[base], lib.packed[copy]) == cfg["edge_radius"]
    for base, copy in outside:
        assert lib.durations[copy] == ends[base] + 1 and copy >= bounds[base]
        assert distance(lib.packed[base], lib.packed[copy]) == cfg["edge_radius"]


def test_clusters(small):
    cfg, lib = small
    clusters = [g for g in lib.planted if len(g) == cfg["cluster_size"]]
    assert len(clusters) == cfg["clusters"]
    for g in clusters:
        base = g[-1]
        assert list(g[:-1]) == list(range(base + 1, base + cfg["cluster_size"]))
        for r in g[:-1]:
            assert distance(lib.packed[base], lib.packed[r]) == cfg["cluster_radius"]
            assert lib.durations[r] == lib.durations[base]
