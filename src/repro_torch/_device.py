"""Device resolution for the port's entry points.

``device=None`` means the card: an entry point never carries on quietly on
the CPU.  Tests and CPU users pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["DeviceArg", "resolve_device", "to_tensor"]

DeviceArg = Union[None, str, torch.device]


def resolve_device(device: DeviceArg = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else is taken
    as given, and a CUDA request without a card raises too."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def to_tensor(x, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array / tensor / sequence -> contiguous tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        a = np.ascontiguousarray(np.asarray(x))
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x.to(device=device, dtype=dtype).contiguous()
