"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller passes ``device="cpu"``.
Asking for the card where there is none raises: nothing falls back to the CPU
on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested (the default) but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
