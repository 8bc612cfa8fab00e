"""Host time of the K3 and K4 wrappers, part by part, on the card.

    python -m com_tpu_torch.tools.perf.host_cost

For ``stamp.stamp_windows`` in both modes (the training path's (2,3,468,468)
canvas, 500 object slots, the callers' dtypes: int32 ids and no values for
the heatmap targets, int64 classes and f32 weights for the COM loss mask)
and for ``nms.greedy_suppress`` at (2,500,500), it times on the host's clock
the whole wrapper, the output's allocation, the C entry called through
``_kernels.launch`` and the same entry called straight through ``ctypes``;
"checks" is the wrapper less the allocation and ``_kernels.launch``: its
argument checks, pointers and counters.  Each part: mean microseconds a
call over ``CALLS`` calls after ``WARMUP`` (the card synchronized before
and after; every kernel here is shorter on the card than its call on the
host, so the host never waits).  Needs a CUDA card.
"""
from __future__ import annotations

import subprocess
import time

import torch

from com_tpu_torch.ops import _kernels, nms, stamp
from com_tpu_torch.utils.device import resolve_device

CALLS = 2000
WARMUP = 50


def host_us(fn, calls=CALLS):
    """Mean host microseconds a call of ``fn``."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _parts(whole, alloc, launch, raw):
    """{part: us}; "checks" is the wrapper less its allocation and launch."""
    t = {"wrapper": host_us(whole), "allocation": host_us(alloc),
         "_kernels.launch": host_us(launch), "ctypes call": host_us(raw)}
    t["checks"] = t["wrapper"] - t["allocation"] - t["_kernels.launch"]
    return t


def run(device=None):
    """One dict a wrapper: the call's name and its parts in microseconds."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("host_cost times the kernels' wrappers: it needs a CUDA device")
    gen = torch.Generator(device=dev).manual_seed(5)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    b, n, c, h, w = 2, 500, 3, 468, 468
    centers = torch.randint(0, w, (b, n, 2), device=dev, generator=gen, dtype=torch.int32)
    radii = torch.randint(2, 24, (b, n), device=dev, generator=gen, dtype=torch.int32)
    cls = torch.randint(0, c, (b, n), device=dev, generator=gen)
    weight = torch.rand((b, n), device=dev, generator=gen) + 0.5
    valid = torch.rand((b, n), device=dev, generator=gen) < 0.2
    out = torch.empty((b, c, h, w), device=dev)
    lib = _kernels.library("stamp")
    rows = []
    for mode, ids, values, fill in (("gauss", cls.int(), None, 0.0),
                                    ("last_wins", cls, weight, 1.0)):
        code, mask = stamp._MODES[mode], stamp._INT64_BIT[ids.dtype] << 2
        ptrs = (centers.data_ptr(), radii.data_ptr(), ids.data_ptr(),
                None if values is None else values.data_ptr(), valid.data_ptr(), out.data_ptr(),
                b, n, c, h, w, 16, code, mask, fill)
        rows.append((f"stamp_windows {mode} (2,3,468,468) 500 slots", _parts(
            lambda i=ids, v=values, m=mode, f=fill: stamp.stamp_windows(
                centers, radii, i, v, valid, c, h, w, m, fill=f),
            lambda: torch.empty((b, c, h, w), dtype=torch.float32, device=dev),
            lambda p=ptrs: _kernels.launch("stamp", "k3_stamp", "K3", index, *p),
            lambda p=ptrs: lib.k3_stamp(*p, stream))))
    k = 500
    over = torch.eye(k, dtype=torch.bool, device=dev).repeat(b, 1, 1)
    alive = torch.ones((b, k), dtype=torch.bool, device=dev)
    keep = torch.empty_like(alive)
    lib = _kernels.library("nms")
    ptrs = (over.data_ptr(), alive.data_ptr(), keep.data_ptr(),
            nms._scratch(b, k, index).data_ptr(), b, k)
    rows.append(("greedy_suppress (2,500,500)", _parts(
        lambda: nms.greedy_suppress(over, alive), lambda: torch.empty_like(alive),
        lambda: _kernels.launch("nms", "k4_greedy_suppress", "K4", index, *ptrs),
        lambda: lib.k4_greedy_suppress(*ptrs, stream))))
    return rows


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else torch.cuda.get_device_name(0))
    for name, parts in run():
        print(f"{name:<46} " + ", ".join(f"{p} {us:.2f}" for p, us in parts.items()) + " us")


if __name__ == "__main__":
    main()
