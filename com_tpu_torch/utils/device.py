"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else the first CUDA
    card.  Without a card, CUDA (asked for or by default) raises: the port
    never moves to the CPU on its own."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device}: pass device='cpu' to run the "
                               "port on the CPU")
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
