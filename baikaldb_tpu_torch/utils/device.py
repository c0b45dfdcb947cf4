"""Which device a port entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises when no CUDA device is available (the
    port never falls back to the CPU); anything else is taken as named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("baikaldb_tpu_torch runs on a CUDA device and none "
                               "is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
