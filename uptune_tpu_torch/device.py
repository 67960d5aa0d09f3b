"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """-> torch.device, refusing a CUDA device on a host without one.

    Entry points default to ``"cuda"``; a host without a card must ask
    for the CPU explicitly (``device="cpu"``) — the port never carries
    on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the port on the CPU")
    return dev
