"""Device resolution for the port's entry points, and the host <-> device
copies the driver and the surrogate manager make."""
from __future__ import annotations

from typing import List, Union

import numpy as np
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


def to_host(*ts: torch.Tensor) -> List[np.ndarray]:
    """numpy copies of tensors that lie on one device.  On the card one
    device->host transfer (one synchronisation) carries them all: each
    tensor's elements as int64 words (float32 by its bit pattern), read
    back into its own dtype and shape."""
    if ts[0].device.type != "cuda":
        return [t.detach().numpy().copy() for t in ts]
    words = torch.cat([
        (t.view(torch.int32) if t.dtype == torch.float32 else t)
        .to(torch.int64).reshape(-1) for t in ts]).cpu().numpy()
    out, off = [], 0
    for t in ts:
        w = words[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
        if t.dtype == torch.float32:
            w = w.astype(np.int32).view(np.float32)
        elif t.dtype == torch.bool:
            w = w.astype(bool)
        elif t.dtype == torch.int32:
            w = w.astype(np.int32)
        out.append(w)
    return out


def to_device(a: np.ndarray, dtype: torch.dtype,
              dev: torch.device) -> torch.Tensor:
    """A host array on `dev` as `dtype`; to the card through pinned
    memory, queued on the stream without a synchronisation."""
    t = torch.from_numpy(np.array(a)).to(dtype)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t
