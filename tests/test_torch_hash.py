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

from vid_dup_finder_lib_tpu.ops.golden import hash_bits_golden
from vid_dup_finder_lib_tpu.ops.hash_kernel import hash_cubes_device
from vid_dup_finder_lib_tpu.ops.hash_pallas import _d3_operator, hash_cubes_pallas
from vid_dup_finder_lib_tpu.video_hash import VideoHash
from vid_dup_finder_lib_tpu_torch import convert
from vid_dup_finder_lib_tpu_torch.ops import hash_kernel as hk


def _port_hash(cubes: np.ndarray, **kw) -> np.ndarray:
    out = hk.hash_cubes(torch.from_numpy(cubes), **kw)
    assert out.dtype == torch.int32 and out.shape == (cubes.shape[0], 32)
    return out.numpy().view(np.uint32)


def _bits_per_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.bitwise_count(a ^ b).sum(axis=1)


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
    """The golden-model corpus of test_golden_model (seed 20): half uniform,
    half low-contrast (128 +/- 2) cubes that crowd the sign boundary."""
    rng = np.random.default_rng(20)
    cubes = np.concatenate(
        [
            rng.integers(0, 256, (256, 16, 16, 16), dtype=np.uint8),
            (128 + rng.integers(-2, 3, (256, 16, 16, 16))).astype(np.uint8),
        ]
    )
    packed = _port_hash(cubes)
    flips = np.array(
        [
            int((hash_bits_golden(cubes[i])
                 != VideoHash.from_packed_u32(packed[i]).hash_bits()).sum())
            for i in range(len(cubes))
        ]
    )
    assert flips.max() <= 2, flips.max()
    assert flips.sum() <= 8, flips.sum()


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
