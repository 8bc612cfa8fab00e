"""Logging, seeding and small host helpers (the port's copy of
``com_tpu/utils/common.py``)."""
from __future__ import annotations

import logging
import random

import numpy as np
import torch


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """A console logger, and a file logger when ``log_file`` is given (it
    replaces the file of an earlier call in the process); ranks other than 0
    log errors only."""
    logger = logging.getLogger(f"com_tpu_torch.r{rank}")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
    if log_file is not None:
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed: int):
    """Seed the host RNGs (numpy drives the augmentation pipeline) and
    torch's, the card's too when there is one.  The cuDNN and TF32
    switches stay as the caller set them."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (B, N, 3+C) points by per-batch yaw angles."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    pts = points[..., :3] @ rot
    return np.concatenate([pts, points[..., 3:]], axis=-1)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period
