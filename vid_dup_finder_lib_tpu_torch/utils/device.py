"""Device resolution for the port's public entry points.

Every entry point takes ``device=None | str | torch.device``.  ``None``
means the card (CUDA's current device): the port runs on the CPU only
when the caller passes ``device="cpu"``.  Asking for CUDA, by name or
by ``None``, on a host without it raises: the port never substitutes the
CPU for the card.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The concrete device for ``device`` (CUDA gets its current index)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested (the default when no device is"
                " given) but torch.cuda.is_available() is False on this"
                " host; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cpu' or 'cuda'")
    return dev
