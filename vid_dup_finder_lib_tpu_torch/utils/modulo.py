"""Wrap-around index arithmetic (counterpart of
``vid_dup_finder_lib_tpu/utils/modulo.py``).

Equivalent of the reference's ``Modulo`` helper used by the GUI carousel
(``vid_dup_finder_app/src/app/gui_slint/modulo.rs:1-40``); kept for the
headless resolver's next/prev navigation.
"""

from __future__ import annotations


def modulo(value: int, m: int) -> int:
    """Euclidean modulo: always in [0, m)."""
    assert m > 0
    return value % m


def wrapping_add(value: int, delta: int, m: int) -> int:
    return modulo(value + delta, m)


def wrapping_sub(value: int, delta: int, m: int) -> int:
    return modulo(value - delta, m)
