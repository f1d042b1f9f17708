"""Device meshes: counterpart of ``vid_dup_finder_lib_tpu/parallel/mesh.py``.

A :class:`Mesh` is the list of devices one process drives, one per shard,
in ring order: the single-controller model of the JAX package's
``jax.sharding.Mesh``, where one call of ``search`` returns the global
groups.  A device may appear more than once, so that several shards share
one card: they then run in turn on it, with the same planning, launches,
copies between shards and merge as shards on cards of their own.  Shards
on distinct devices run at once (:func:`run_by_device`).
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Callable

import torch

from ..utils.device import resolve_device


class Mesh(tuple):
    """An immutable sequence of ``torch.device``s, one per shard, in ring
    order.  Every entry is resolved (:func:`..utils.device.resolve_device`:
    a CUDA device on a host without CUDA raises) and all are of one type."""

    def __new__(cls, devices) -> "Mesh":
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {list(devs)}")
        return super().__new__(cls, devs)

    @property
    def size(self) -> int:
        return len(self)

    def shards_per_device(self) -> Counter:
        """How many shards each distinct device holds."""
        return Counter(self)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self]})"


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh of ``n_devices`` shards on ``device``'s type (``None``: the
    card).  On CUDA the first ``n_devices`` cards, all visible cards by
    default; it raises when fewer are visible.  On the CPU ``n_devices``
    CPU shards, one by default."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got n_devices={n_devices}")
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices))
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count:
        raise ValueError(f"need {n} CUDA devices, have {count}")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def run_by_device(jobs: list[tuple[torch.device, Callable]]) -> list:
    """Run ``jobs``, ``(device, fn)`` pairs, and return their results in
    order.  The jobs of one device run in turn, those of distinct devices
    at once: one host thread per device, which waits on its own card
    (PyTorch's and ctypes' calls release the GIL while they wait) on the
    stream that is current for that card in the calling thread.  Jobs of
    a single device run in the calling thread.  A job's exception is
    raised here, after every thread has ended."""
    by_dev: dict[torch.device, list[int]] = {}
    for k, (dev, _) in enumerate(jobs):
        by_dev.setdefault(dev, []).append(k)
    if len(by_dev) <= 1:
        return [fn() for _, fn in jobs]
    out = [None] * len(jobs)
    errors = []

    def run(ks, stream):
        try:
            with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
                for k in ks:
                    out[k] = jobs[k][1]()
        except BaseException as e:  # noqa: BLE001 -- raised in the calling thread
            errors.append(e)

    threads = [
        threading.Thread(target=run, args=(ks, torch.cuda.current_stream(d) if d.type == "cuda" else None))
        for d, ks in by_dev.items()
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out
