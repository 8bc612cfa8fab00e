"""The native host ops of the input pipeline: ``csrc/host/com_native.cpp``
built with ``g++`` and bound with ``ctypes`` (counterpart of
``com_tpu/ops/native``).

The library is built at first use into ``build/host/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source, the flags
and the machine type, and loaded once a process.  There is no fallback: a
wrapper calls the library, and raises when it cannot be built.  The numpy
versions (``ops.voxelize.voxelize_points``, ``ops.host_boxes.
points_in_rbbox`` and ``boxes_iou_bev``) are the tests' oracle; a caller
picks them only by name.  ``-ffp-contract=off`` keeps the products and sums
rounded one at a time on every machine, as numpy rounds them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "com_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")

P, I64 = ctypes.c_void_p, ctypes.c_int64
# C signatures: name -> (restype, argtypes); pointers as c_void_p
SIGNATURES = {
    "voxelize": (I64, (P, I64, I64, P, P, I64, I64, P, P, P)),
    "boxes_iou_bev": (None, (P, I64, P, I64, P)),
    "points_in_rbbox": (None, (P, I64, I64, P, I64, P)),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode() + platform.machine().encode())
    return BUILD_DIR / f"libcom_native-{h.hexdigest()[:12]}.so"


def _build(so: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library csrc/host/com_native.cpp needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders each rename a whole library


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            for fn, (res, args) in SIGNATURES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = list(args)
            _lib = lib
    return _lib


def _f32(a, cols=None):
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or (cols is not None and a.shape[1] < cols):
        raise ValueError(f"expected a 2-D array of at least {cols} columns, got {a.shape}")
    return a


def voxelize_native(points, pc_range, voxel_size, max_points_per_voxel, max_voxels):
    """Hard voxelization with the contract of ``ops.voxelize.voxelize_points``
    (first-come voxels and points, (V, T, F) voxels, zyx coords, counts),
    trimmed to the voxels written."""
    points = _f32(points, 3)
    n, f = points.shape
    pc_range = np.ascontiguousarray(pc_range, np.float32)
    voxel_size = np.ascontiguousarray(voxel_size, np.float32)
    if pc_range.shape != (6,) or voxel_size.shape != (3,):
        raise ValueError("pc_range has 6 values and voxel_size 3")
    # np.empty: the library zeroes the unwritten tail of every voxel it writes
    voxels = np.empty((max_voxels, max_points_per_voxel, f), np.float32)
    coords = np.full((max_voxels, 3), -1, np.int32)
    num_points = np.zeros((max_voxels,), np.int32)
    nv = library().voxelize(points.ctypes.data, n, f, pc_range.ctypes.data,
                            voxel_size.ctypes.data, int(max_points_per_voxel), int(max_voxels),
                            voxels.ctypes.data, coords.ctypes.data, num_points.ctypes.data)
    return voxels[:nv], coords[:nv], num_points[:nv]


def boxes_iou_bev_native(boxes_a, boxes_b):
    """Rotated BEV IoU (N, 7+) x (M, 7+) -> (N, M) f32 by polygon clipping."""
    a = np.ascontiguousarray(_f32(boxes_a, 7)[:, :7])
    b = np.ascontiguousarray(_f32(boxes_b, 7)[:, :7])
    out = np.zeros((len(a), len(b)), np.float32)
    library().boxes_iou_bev(a.ctypes.data, len(a), b.ctypes.data, len(b), out.ctypes.data)
    return out


def points_in_rbbox_native(points, boxes):
    """(N, 3+) points x (M, 7+) boxes -> (N, M) bool containment mask."""
    p = _f32(points, 3)
    b = np.ascontiguousarray(_f32(boxes, 7)[:, :7])
    mask = np.zeros((len(p), len(b)), np.uint8)
    library().points_in_rbbox(p.ctypes.data, len(p), p.shape[1], b.ctypes.data, len(b),
                              mask.ctypes.data)
    return mask.astype(bool)
