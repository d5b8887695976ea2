"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device.

    Raises when CUDA is asked for (explicitly or by default) and missing:
    an entry point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
