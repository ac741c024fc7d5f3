"""Device selection shared by the port's entry points.

Entry points take ``device=None``, which means ``"cuda"``.  Only an
explicit ``device="cpu"`` runs on the CPU; a CUDA request on a host
without CUDA raises instead of falling back.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (device=None means 'cuda') but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the CPU")
    return dev
