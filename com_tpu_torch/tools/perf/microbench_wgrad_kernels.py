"""Sweep of the weight-gradient formulations T1-T4 (and K2w) on the card.

    python -m com_tpu_torch.tools.perf.microbench_wgrad_kernels

Counterpart of ``tools/perf/microbench_wgrad_kernels.py``: the four ways to
hand the weight gradient of the backbone's 3x3 conv to a matrix unit
(``ops/wgrad_variants.py``, kernels in ``csrc/wgrad_variants.cu``) at the
468x468 shapes, each at row tiles of th = 8 and 16:

  gt9     g^T once, nine products with x's shifted views (T3)     default
  gtcol   g^T once, one product with an x column buffer (T4)      default
  gcol    one product x^T . g_col, g shifted per tap (T1)         WG_COL=1
  xcol    one product x_col^T . g, taps along M (T2)              WG_COL=1
  v0      the port's K2w (``ops/conv2d.py`` conv3x3_wgrad)        WG_V0=1

``WG_ITERS=N`` sets the timed calls (default 20).  Inputs are N(0, 1) * 0.3
in bf16 from a seeded generator on the device.  Each line gives the mean
time a call (CUDA events over the timed calls, after two warm-up calls) and
its TFLOP/s, then ``err`` = max|out - oracle| / max|oracle| against the f32
einsum oracle.  A kernel failure raises.  ``run`` returns the lines as
dicts; with ``device="cpu"`` it calls each plain version once and times
nothing.
"""
from __future__ import annotations

import os

import torch

from com_tpu_torch.ops import conv2d, wgrad_variants
from com_tpu_torch.utils.device import resolve_device

SHAPES = ((2, 468, 468, 64, 64), (2, 468, 468, 128, 64))
THS = (8, 16)
WARMUP = 2
TOL = 1e-5  # |out - oracle| <= TOL * sum |x||g|, element by element (bf16 products are exact)


def _timed(fn, iters, dev):
    """fn's output, its mean ms a call on the card (None on the CPU) and the
    number of calls made."""
    out = fn()
    if dev.type != "cuda":
        return out, None, 1
    for _ in range(WARMUP):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / iters, 1 + WARMUP + iters


def run(shapes=SHAPES, ths=THS, variants=("gt9", "gtcol"), iters=20, device=None):
    """Time and check each variant (``"v0"`` for K2w) at each shape and th;
    one dict a line: shape, name, variant, th (None for v0), ms and tflops
    (None on the CPU), err, ok (within ``TOL``) and calls."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for b, h, wd, cin, cout in shapes:
        x = (torch.randn((b, h, wd, cin), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        g = (torch.randn((b, h, wd, cout), generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        flops = 2 * b * h * wd * 9 * cin * cout
        print(f"--- {h}x{wd} cin{cin} cout{cout} (wgrad {flops / 1e9:.1f} GFLOP)", flush=True)
        ref = wgrad_variants.oracle(x, g)
        absref = wgrad_variants.oracle(x.abs(), g.abs())
        scale = float(ref.abs().max())
        cases = [("v0", None)] if "v0" in variants else []
        cases += [(v, th) for th in ths for v in variants if v != "v0"]
        for variant, th in cases:
            if variant == "v0":
                name, fn = "v0 current", lambda: conv2d.conv3x3_wgrad(x, g)
            else:
                wrapper = wgrad_variants.VARIANTS[variant][0]
                name, fn = f"{variant} th={th}", lambda: wrapper(x, g, th)
            out, ms, calls = _timed(fn, iters, dev)
            diff = (out - ref).abs()
            err = float(diff.max()) / scale
            rate = None if ms is None else flops / ms / 1e9
            if ms is None:
                print(f"{name:36s} not timed (no card)", flush=True)
            else:
                print(f"{name:36s} {ms:8.3f} ms  {rate:6.1f} TFLOP/s", flush=True)
            print(f"    {variant} err {err:.2e}", flush=True)
            rows.append(dict(shape=(b, h, wd, cin, cout), name=name, variant=variant, th=th,
                             ms=ms, tflops=rate, err=err,
                             ok=bool((diff <= TOL * absref).all()), calls=calls))
    return rows


def main():
    variants = ["gt9", "gtcol"]
    if os.environ.get("WG_COL", "0") == "1":
        variants += ["gcol", "xcol"]
    if os.environ.get("WG_V0", "0") == "1":
        variants.insert(0, "v0")
    dev = resolve_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the oracle's einsums in full f32
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    run(SHAPES, THS, variants, int(os.environ.get("WG_ITERS", 20)), dev)


if __name__ == "__main__":
    main()
