"""The port's one device rule: ``cuda`` unless the caller names a device."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card. Raises when ``None`` is given and no card is visible — an
    entry point never falls back to the CPU on its own (pass
    ``device="cpu"`` to ask for it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible and no device= was given; the "
            "port runs on the card by default (pass device='cpu' to run "
            "the plain PyTorch paths on the CPU)"
        )
    return torch.device("cuda", torch.cuda.current_device())
