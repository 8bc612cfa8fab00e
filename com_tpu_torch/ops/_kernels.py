"""Build and load the hand-written CUDA kernels under ``com_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
and are built at first use.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("seg_scan", "conv3x3", "conv3x3_wgrad", "stamp", "nms", "wgrad_variants")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: name -> (restype, argtypes).  Pointers and the stream are
# c_void_p: ctypes would pass a bare Python int as a 32-bit int.
SIGNATURES = {
    "seg_scan": {
        "k1_tile_rows": (I, (I, I, I)),
        "k1_call": (I, (P, P, P, P, P, P, I, I, I, I, I, P)),
    },
    "conv3x3": {
        "k2_conv3x3_f32": (I, (P, P, P, I, I, I, I, I, P)),
        "k2_conv3x3_bf16": (I, (P, P, P, I, I, I, I, I, P)),
    },
    "conv3x3_wgrad": {
        "k2w_resident_blocks_f32": (I, ()),
        "k2w_conv3x3_wgrad_f32": (I, (P, P, P, P, I, I, I, I, I, I, P)),
        "k2w_resident_blocks_bf16": (I, ()),
        "k2w_conv3x3_wgrad_bf16": (I, (P, P, P, P, I, I, I, I, I, I, I, P)),
    },
    "stamp": {
        "k3_tile": (I, (I,)),
        "k3_stamp": (I, (P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, P)),
    },
    "nms": {
        "k4_max_candidates": (I, ()),
        "k4_greedy_suppress": (I, (P, P, P, P, I, I, P)),
    },
    "wgrad_variants": {
        "t1_resident_blocks": (I, ()),
        "t2_resident_blocks": (I, ()),
        "t3_resident_blocks": (I, ()),
        "t4_resident_blocks": (I, ()),
        "t1_wgrad_gcol": (I, (P, P, P, P, I, I, I, I, I, I, I, I, P)),
        "t2_wgrad_xcol": (I, (P, P, P, P, I, I, I, I, I, I, I, I, P)),
        "t3_wgrad_gt9": (I, (P, P, P, P, I, I, I, I, I, I, I, I, P)),
        "t4_wgrad_gtcol": (I, (P, P, P, P, I, I, I, I, I, I, I, I, P)),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # wall time of each build this process ran


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to, named by a hash of the source, every
    shared header under csrc/ (``*.cuh``) and the flags, so that an edit to
    any of them builds anew."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNELS) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in jobs.items():  # wait for every job before raising
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)  # loaded libraries are never replaced: no lock to read one
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            for fn, (res, args) in SIGNATURES[name].items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = list(args)
            _libs[name] = lib
        return lib


def check_device(what: str, t) -> None:
    """The registered ops take CPU tensors (the plain version) and CUDA
    tensors (the kernel).  A tensor on another device, a meta tensor among
    them, raises here rather than reaching an op's fake implementation."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def launch(name: str, fn: str, what: str, index: int, *args) -> None:
    """Call the C entry ``fn`` of csrc/<name>.cu as ``fn(*args, stream)`` on
    the current stream of CUDA device ``index`` (``tensor.get_device()``),
    and raise if it reports an error.  The device is made current for the
    call only where it is not already; the stream's raw handle is read
    without building a Stream object."""
    import torch

    entry = getattr(library(name), fn)
    if torch.cuda.current_device() == index:
        err = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, what)
