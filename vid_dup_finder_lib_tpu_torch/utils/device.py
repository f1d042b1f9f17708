"""Device resolution for the port's public entry points.

Every entry point takes ``device=None | str | torch.device``.  ``None``
means PyTorch's default device (``torch.get_default_device()``).  Asking
for CUDA on a host without it raises: the port never substitutes the CPU
for a device the caller named.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The concrete device for ``device`` (CUDA gets its current index)."""
    dev = torch.get_default_device() if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is"
                " False on this host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev
