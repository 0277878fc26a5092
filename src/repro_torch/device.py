"""Device selection shared by every entry point of the port."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a card and without an explicit device this raises —
    the port never quietly runs its plain CPU path in place of the
    kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        # tensors report their card's index ("cuda:0"): name it, so that
        # device equality checks compare like with like
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
