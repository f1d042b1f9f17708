"""Host-to-device copies through one reusable pinned staging buffer.

A pageable ``Tensor.to(device)`` of a fresh host array pays for the array's
first-touch pages and CUDA's own bounce copies; pinning each array
anew (``Tensor.pin_memory``) costs a pinned allocation and a full host copy
before the DMA can start.  :func:`upload_into` and :func:`to_device` instead
copy the bytes through two pinned halves that live for the process: while
the card reads one half, the host fills the other, so the host copy and the
DMA overlap.
A half is rewritten only after the CUDA event recorded behind its last DMA
has completed.  The copies are queued on the destination device's current
stream, so the work queued after them on that stream sees the data; the
call returns once the last copy is queued, and the source may change from
then on.

The buffer (``HALF_BYTES`` twice) is allocated at the first upload and kept;
a failure to pin or to copy raises, and nothing falls back to a pageable
copy.  Threads share the buffer under a lock.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

# bytes of each of the two pinned halves: the host's copy into one half
# outlasts the DMA of the other, and pinning both at the first upload
# stays a small part of that upload
HALF_BYTES = 16 * 2**20


class PinnedStaging:
    """Two pinned host halves of ``half_bytes`` each, and the event behind
    each half's last DMA."""

    def __init__(self, half_bytes: int = HALF_BYTES) -> None:
        self.half_bytes = int(half_bytes)
        self._halves: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._lock = threading.Lock()

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """Copy the contiguous host tensor ``src`` into the contiguous CUDA
        tensor ``dst`` of the same byte size, half by half."""
        if dst.device.type != "cuda" or src.device.type != "cpu":
            raise ValueError(f"staging copies host to CUDA, not {src.device} to {dst.device}")
        if not (dst.is_contiguous() and src.is_contiguous()):
            raise ValueError("staging copies contiguous tensors only")
        nbytes = src.numel() * src.element_size()
        if dst.numel() * dst.element_size() != nbytes:
            raise ValueError(
                f"staging: {nbytes} source bytes for {dst.numel() * dst.element_size()}"
                " destination bytes"
            )
        if nbytes == 0:
            return
        s = src.reshape(-1).view(torch.uint8)
        d = dst.reshape(-1).view(torch.uint8)
        with self._lock:
            if not self._halves:
                self._halves = [
                    torch.empty(self.half_bytes, dtype=torch.uint8, pin_memory=True)
                    for _ in range(2)
                ]
            stream = torch.cuda.current_stream(dst.device)
            for k, off in enumerate(range(0, nbytes, self.half_bytes)):
                i = k % 2
                m = min(self.half_bytes, nbytes - off)
                if self._events[i] is not None:
                    self._events[i].synchronize()  # its last DMA has read it
                half = self._halves[i][:m]
                half.copy_(s[off : off + m])
                d[off : off + m].copy_(half, non_blocking=True)
                event = torch.cuda.Event()
                event.record(stream)
                self._events[i] = event


_STAGING = PinnedStaging()


def host_tensor(host: np.ndarray) -> torch.Tensor:
    """A contiguous host array as a CPU tensor sharing its memory (a
    read-only array too: the staging only reads it)."""
    host = np.ascontiguousarray(host)
    if host.flags.writeable:
        return torch.from_numpy(host)
    with warnings.catch_warnings():  # torch warns that it cannot mark it read-only
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(host)


def upload_into(dst: torch.Tensor, src: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Copy a host array or tensor into the CUDA tensor ``dst`` through the
    module's staging buffer (:class:`PinnedStaging`); returns ``dst``."""
    if isinstance(src, np.ndarray):
        src = host_tensor(src)
    _STAGING.copy(dst, src.contiguous())
    return dst


def to_device(src: torch.Tensor | np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``: a new tensor of the same dtype
    and shape through the staging buffer when ``device`` is a CUDA device
    and ``src`` lies on the host, else ``Tensor.to``."""
    if isinstance(src, np.ndarray):
        src = host_tensor(src)
    if src.device.type != "cpu" or device.type != "cuda":
        return src.to(device)
    return upload_into(torch.empty(src.shape, dtype=src.dtype, device=device), src)
