"""The port's device names."""
from __future__ import annotations

import torch


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in, so that "cuda" and "cuda:0"
    (the current card) are one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return dev
