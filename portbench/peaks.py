"""Peak rates of the card and the work a sweep needs, for roofline shares.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at
its full 700 W power limit; a card set below it runs slower, so a share
is reported with the card's ``power.limit`` beside it.
"""

from __future__ import annotations

# int8 tensor-core operations per second (dense)
H100_INT8_OPS = 1.979e15


def sweep_ops(pairs: int, bits: int) -> float:
    """int8 operations of a banded sweep: one multiply and one add per bit
    of the hash for each in-band pair, the hash as +1/-1 bytes.  Only the
    hash's own bits count: padding them to a tile's width is a choice of
    the kernel, not work the search needs."""
    return float(pairs) * bits * 2


def sweep_bound_s(pairs: int, bits: int) -> float:
    """The least time one H100 takes for a banded sweep of ``pairs`` over
    ``bits``-bit hashes."""
    return sweep_ops(pairs, bits) / H100_INT8_OPS
