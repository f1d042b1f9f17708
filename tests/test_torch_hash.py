"""The port's batch hash (``vid_dup_finder_lib_tpu_torch.ops.hash_kernel``)
against the JAX package's fused Pallas hash (interpret mode), its XLA hash
and the f64 golden model.

Tolerance: fp32 sums can flip the sign of a coefficient within fp32
rounding of zero, so a hash may differ from another fp32 implementation or
from the f64 model in a few bits: <= 2 bits in any hash, and <= 8 flips
over the 512-cube golden corpus (the bound tests/test_golden_model.py pins
for the JAX package).
"""

import numpy as np
import pytest
import torch

from vid_dup_finder_lib_tpu.ops.golden import dct2_matrix, hash_bits_golden
from vid_dup_finder_lib_tpu.ops.hash_kernel import hash_cubes_device
from vid_dup_finder_lib_tpu.ops.hash_pallas import _d3_operator, hash_cubes_pallas
from vid_dup_finder_lib_tpu.video_hash import VideoHash
from vid_dup_finder_lib_tpu_torch import convert
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk
from vid_dup_finder_lib_tpu_torch.ops.golden import hash_bits_golden as port_hash_bits_golden
from vid_dup_finder_lib_tpu_torch.tools.k1_flat_cubes import flat_cube_report, flat_cubes
from vid_dup_finder_lib_tpu_torch.tools.k1_flat_cubes import main as k1_flat_cubes_main


def _port_hash(cubes: np.ndarray, **kw) -> np.ndarray:
    out = hk.hash_cubes(torch.from_numpy(cubes), **kw)
    assert out.dtype == torch.int32 and out.shape == (cubes.shape[0], 32)
    return out.numpy().view(np.uint32)


def _bits_per_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.bitwise_count(a ^ b).sum(axis=1)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf on float32 values: the product of two f32 values is exact in
    f64, so one f64 sum and one rounding to f32 (a double rounding that
    differs from fmaf only at an f32 midpoint)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def separable_hash_fp32(cubes: np.ndarray) -> np.ndarray:
    """uint8[B, 16, 16, 16] (t, y, x) -> uint32[B, 32]: ``hash_dct_kernel``'s
    arithmetic in its exact order -- each coefficient a chain of fmaf from
    0 over ascending y, then x, then t, with the f32 factor
    ``hk.dct_rows()`` -- then sign and LSB-first packing."""
    d = hk.dct_rows()  # [10, 16] f32
    v = cubes.astype(np.float32) - np.float32(128)  # [B, t, y, x], exact
    n = cubes.shape[0]
    a = np.zeros((n, 16, 16, 10), np.float32)  # [B, t, x, k]
    for y in range(16):
        a = _fma32(d[:, y], v[:, :, y, :, None], a)
    b = np.zeros((n, 16, 10, 10), np.float32)  # [B, t, j, k]
    for x in range(16):
        b = _fma32(d[:, x, None], a[:, :, x, None, :], b)
    c = np.zeros((n, 10, 10, 10), np.float32)  # [B, i, j, k]
    for t in range(16):
        c = _fma32(d[:, t, None, None], b[:, t, None, :, :], c)
    bits = np.zeros((n, 1024), np.uint32)
    bits[:, :1000] = (c > 0).reshape(n, 1000)
    return (bits.reshape(n, 32, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32
    )


def golden_corpus() -> np.ndarray:
    """The golden-model corpus of test_golden_model (seed 20): half uniform,
    half low-contrast (128 +/- 2) cubes that crowd the sign boundary."""
    rng = np.random.default_rng(20)
    return np.concatenate(
        [
            rng.integers(0, 256, (256, 16, 16, 16), dtype=np.uint8),
            (128 + rng.integers(-2, 3, (256, 16, 16, 16))).astype(np.uint8),
        ]
    )


def _flips_vs_golden(cubes: np.ndarray, packed: np.ndarray) -> np.ndarray:
    return np.array(
        [
            int((hash_bits_golden(cubes[i])
                 != VideoHash.from_packed_u32(packed[i]).hash_bits()).sum())
            for i in range(len(cubes))
        ]
    )


def test_d3_operator_is_bit_equal_to_pallas_operator():
    ours = hk.d3_operator()
    ref = _d3_operator()
    assert ours.dtype == np.float32 and ours.shape == (1024, 4096)
    np.testing.assert_array_equal(ours, ref)
    # the k-major device copy holds the same values, rows in cube order
    dev = convert.d3_from_numpy(ref, device="cpu")
    assert dev.shape == (4096, 1024)
    np.testing.assert_array_equal(dev.numpy(), hk._d3_on(torch.device("cpu")).numpy())
    np.testing.assert_array_equal(dev.numpy()[:, :1000].T.reshape(1000, 16, 16, 16),
                                  ref[:1000].reshape(1000, 16, 16, 16).transpose(0, 1, 3, 2))


@pytest.mark.parametrize("jax_fn", ["pallas_interpret", "xla"])
def test_hash_matches_jax_hash(jax_fn):
    rng = np.random.default_rng(4)
    cubes = rng.integers(0, 256, (200, 16, 16, 16), dtype=np.uint8)  # not % 128
    if jax_fn == "pallas_interpret":
        ref = hash_cubes_pallas(cubes, interpret=True)
    else:
        ref = hash_cubes_device(cubes)
    ours = _port_hash(cubes)
    d = _bits_per_hash(ours, ref)
    assert d.max() <= 2, d.max()
    assert d.sum() <= 8, d.sum()
    assert not (ours[:, -1] >> np.uint32(8)).any()  # bins 1000..1023 are 0


def test_hash_vs_golden_large_corpus():
    """The golden-model corpus: the plain version within the pinned bound."""
    cubes = golden_corpus()
    flips = _flips_vs_golden(cubes, _port_hash(cubes))
    assert flips.max() <= 2, flips.max()
    assert flips.sum() <= 8, flips.sum()


def test_separable_fp32_order_vs_golden():
    """The CUDA kernel's contraction order (y, x, t in fp32 FMAs with the
    f32 factor) meets the same bound against the f64 golden model on the
    golden corpus: <= 2 bits in any hash, <= 8 flips in all."""
    cubes = golden_corpus()
    flips = _flips_vs_golden(cubes, separable_hash_fp32(cubes))
    assert flips.max() <= 2, flips.max()
    assert flips.sum() <= 8, flips.sum()


def test_separable_fp32_order_vs_jax_pallas_hash():
    """... and against the JAX package's Pallas hash (interpret mode), which
    sums the collapsed operator in its own fp32 order."""
    rng = np.random.default_rng(4)
    cubes = rng.integers(0, 256, (200, 16, 16, 16), dtype=np.uint8)
    ref = hash_cubes_pallas(cubes, interpret=True)
    ours = separable_hash_fp32(cubes)
    d = _bits_per_hash(ours, ref)
    assert d.max() <= 2, d.max()
    assert d.sum() <= 8, d.sum()
    assert not (ours[:, -1] >> np.uint32(8)).any()  # bins 1000..1023 are 0


@pytest.mark.parametrize("value", [0, 77, 128, 255])
def test_flat_cube_bin0_is_exact(value):
    """Flat cubes: every AC coefficient is exactly 0, so only bin 0 (the
    exact sum 4096 (v - 128)) has a defined sign; the separable order gets
    it right, and a cube of 128s packs to all-zero words."""
    cube = np.full((1, 16, 16, 16), value, np.uint8)
    words = separable_hash_fp32(cube)
    assert bool(words[0, 0] & 1) == bool(hash_bits_golden(cube[0])[0]) == (value > 128)
    if value == 128:
        assert not words.any()


def test_flat_cube_report_on_the_cpu():
    """``tools/k1_flat_cubes.flat_cube_report`` on the CPU, where
    ``hash_cubes`` is the plain version: no bits against the plain version,
    bin 0 and the 128 cube exact, and its golden count equal to one made
    with the JAX package's golden model and ``VideoHash`` bit order."""
    r = flat_cube_report(hk.hash_cubes, hk.hash_cubes_plain, port_hash_bits_golden,
                         torch.device("cpu"))
    assert r["flat_cubes"] == 256
    assert r["same_on_two_launches"] and r["bin0_exact"] and r["cube128_zero"]
    assert r["vs_plain_bits"] == r["vs_plain_worst"] == 0
    cubes = flat_cubes()
    words = _port_hash(cubes)
    gold = [int((VideoHash.from_packed_u32(words[v]).hash_bits()
                 != hash_bits_golden(cubes[v])).sum()) for v in range(256)]
    assert (r["vs_golden_bits"], r["vs_golden_worst"]) == (sum(gold), max(gold))


def test_k1_flat_cubes_script_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the check is for CUDA-less hosts")
    assert k1_flat_cubes_main([]) == 1


def test_dct_rows_from_numpy_equals_jax_dct_rows():
    rows = dct2_matrix(16, np.float64)[:10]
    got = convert.dct_rows_from_numpy(rows, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (10, 16)
    np.testing.assert_array_equal(got.numpy(), rows.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), hk.dct_rows())
    np.testing.assert_array_equal(hk._dct_on(torch.device("cpu")).numpy(), hk.dct_rows())
    with pytest.raises(ValueError):
        convert.dct_rows_from_numpy(np.zeros((16, 10)), device="cpu")


def test_cpu_path_refuses_the_kernel_factor():
    """``dct=`` is the CUDA kernel's operand: the CPU path, which runs the
    collapsed plain version, refuses it rather than ignoring it."""
    cubes = torch.zeros((1, 16, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="d3="):
        hk.hash_cubes(cubes, dct=torch.from_numpy(hk.dct_rows()))


def test_cube_orientation_is_transposed_frame():
    """cube[t, x, y] = frame_t[y, x] - 128: a cube and its row/column
    transpose hash differently, and only the right one matches golden."""
    rng = np.random.default_rng(6)
    cube = rng.integers(0, 256, (16, 16, 16), dtype=np.uint8)
    ours = VideoHash.from_packed_u32(_port_hash(cube[None])[0]).hash_bits()
    flipped = VideoHash.from_packed_u32(
        _port_hash(np.ascontiguousarray(cube.transpose(0, 2, 1))[None])[0]
    ).hash_bits()
    gold = hash_bits_golden(cube)
    assert (ours != gold).sum() <= 2
    assert (flipped != gold).sum() > 100


def test_explicit_operator_and_empty_batch():
    rng = np.random.default_rng(7)
    cubes = rng.integers(0, 256, (5, 16, 16, 16), dtype=np.uint8)
    d3 = convert.d3_from_numpy(_d3_operator(), device="cpu")
    np.testing.assert_array_equal(_port_hash(cubes, d3=d3), _port_hash(cubes))
    assert _port_hash(np.zeros((0, 16, 16, 16), np.uint8)).shape == (0, 32)


def test_plain_version_is_the_cpu_path():
    rng = np.random.default_rng(8)
    cubes = torch.from_numpy(rng.integers(0, 256, (3, 16, 16, 16), dtype=np.uint8))
    before = hk.hash_cubes.launches
    np.testing.assert_array_equal(hk.hash_cubes(cubes).numpy(),
                                  hk.hash_cubes_plain(cubes).numpy())
    assert hk.hash_cubes.launches == before  # no kernel launch on the CPU


@pytest.mark.parametrize(
    "bad",
    [
        np.zeros((2, 16, 16, 16), np.int16),
        np.zeros((2, 16, 16), np.uint8),
        np.zeros((2, 16, 16, 15), np.uint8),
    ],
)
def test_rejects_bad_cubes(bad):
    with pytest.raises(ValueError):
        hk.hash_cubes(torch.from_numpy(bad))


def test_rejects_bad_operator():
    cubes = torch.zeros((1, 16, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hk.hash_cubes(cubes, d3=torch.zeros((1024, 4096)))
    with pytest.raises(ValueError):
        convert.d3_from_numpy(np.zeros((4096, 1024), np.float32), device="cpu")
