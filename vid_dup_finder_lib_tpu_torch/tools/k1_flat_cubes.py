"""K1 on flat cubes: how far a checkout's hash kernel lands from its plain
version and from the f64 golden model on the 256 constant cubes 0..255.

Every AC coefficient of a constant cube is exactly 0, so its AC sign bits
are rounding noise of whichever order computes them.  This reads that
noise for one checkout, so that two trees (say a commit and its parent)
can be compared on one card:

    python vid_dup_finder_lib_tpu_torch/tools/k1_flat_cubes.py [--root DIR]

``--root`` names the checkout whose ``vid_dup_finder_lib_tpu_torch`` is
imported (default: the one that holds this file).  Prints one JSON object.
The module imports nothing of the package itself: :func:`flat_cube_report`
takes the functions it measures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

N_FLAT = 256  # one cube per u8 value


def flat_cubes() -> np.ndarray:
    """uint8[256, 16, 16, 16]: cube v holds the value v everywhere."""
    return np.repeat(np.arange(N_FLAT, dtype=np.uint8), 16**3).reshape(N_FLAT, 16, 16, 16)


def _bits(words: np.ndarray) -> np.ndarray:
    """uint32[B, 32] -> bool[B, 1000], bin b = bit b % 32 of word b // 32."""
    return np.unpackbits(words.astype("<u4").view(np.uint8), axis=1,
                         bitorder="little")[:, :1000].astype(bool)


def flat_cube_report(hash_cubes, hash_cubes_plain, hash_bits_golden,
                     device: torch.device) -> dict:
    """Hash the flat cubes on ``device`` with ``hash_cubes`` (twice) and
    ``hash_cubes_plain``; count the flipped bits against the plain version
    and against ``hash_bits_golden``, and check what is exact: bin 0 (set
    for v > 128) and the all-zero words of the 128 cube."""
    cubes_np = flat_cubes()
    cubes = torch.from_numpy(cubes_np).to(device)
    words = hash_cubes(cubes)
    again = hash_cubes(cubes)
    plain = hash_cubes_plain(cubes)
    k = words.cpu().numpy().view(np.uint32)
    vs_plain = np.bitwise_count(k ^ plain.cpu().numpy().view(np.uint32)).sum(1)
    gold = np.stack([hash_bits_golden(c) for c in cubes_np])
    vs_golden = (_bits(k) != gold).sum(1)
    return dict(
        flat_cubes=N_FLAT,
        same_on_two_launches=bool(torch.equal(words, again)),
        bin0_exact=bool(np.array_equal(k[:, 0] & 1, (np.arange(N_FLAT) > 128).astype(np.uint32))),
        cube128_zero=not k[128].any(),
        vs_plain_bits=int(vs_plain.sum()), vs_plain_worst=int(vs_plain.max()),
        vs_golden_bits=int(vs_golden.sum()), vs_golden_worst=int(vs_golden.max()),
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose port is measured")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_flat_cubes: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from vid_dup_finder_lib_tpu_torch.ops.golden import hash_bits_golden
    from vid_dup_finder_lib_tpu_torch.ops.hash_kernel import hash_cubes, hash_cubes_plain

    report = flat_cube_report(hash_cubes, hash_cubes_plain, hash_bits_golden,
                              torch.device("cuda"))
    print(json.dumps(dict(root=root, device=torch.cuda.get_device_name(0), **report)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
