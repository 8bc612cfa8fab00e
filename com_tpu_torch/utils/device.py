"""Device choice for the port's entry points."""
from __future__ import annotations

import os

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


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` (torchrun), else
    ``SLURM_LOCALID``, else 0."""
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", 0)))


def rank_device(device=None) -> torch.device:
    """``resolve_device`` for one rank of several: the caller's device, but
    ``cuda`` without an index (or no device) is ``cuda:LOCAL_RANK``.
    Without a card, CUDA raises."""
    if device is not None and (torch.device(device).type != "cuda"
                               or torch.device(device).index is not None):
        return resolve_device(device)
    return resolve_device(torch.device("cuda", local_rank()))
