"""Tile sweep of the tensor-core K2 and K2w on the card.

    python -m com_tpu_torch.tools.perf.conv_tiles [VARIANT ...]

Builds copies of ``csrc/conv3x3.cu`` / ``csrc/conv3x3_wgrad.cu`` with their
tile constants replaced and times each bf16 entry point at the backbone's
three shapes (2,468,468,64->64), (2,234,234,128->128), (2,117,117,256->256)
against the plain version.  A variant names the kernel and its constants,
with an optional diagnostic:

  k2:TR,KC,STAGES              kTR, kKc, kStages of conv3x3.cu
  k2w:DY,CI,CO,WARPS_M,STAGES  kDY, kCi, kCo, kWarpsM, kStages of conv3x3_wgrad.cu
  ...,noload                   stages loaded only before the main loop (the
                               products run on stale data): the time without
                               the loads
  ...,nomma                    each mma.sync replaced by one add: the time
                               without the products

Without arguments it runs the shipped tiles and the two diagnostics of each.
Each line: mean ms a call (CUDA events over ``ITERS`` calls after two
warm-up calls), TFLOP/s, and whether the output is within the tolerance of
``chip_smoke.py`` (diagnostics are wrong by design).  Builds go to
``build/conv_tiles/``.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from com_tpu_torch.ops import _kernels, conv2d
from com_tpu_torch.utils.device import resolve_device

SHAPES = ((2, 468, 468, 64, 64), (2, 234, 234, 128, 128), (2, 117, 117, 256, 256))
ITERS = 20
CONSTANTS = {"k2": ("conv3x3", ("kTR", "kKc", "kStages")),
             "k2w": ("conv3x3_wgrad", ("kDY", "kCi", "kCo", "kWarpsM", "kStages"))}
DEFAULT = ("k2:8,32,2", "k2:8,32,2,noload", "k2:8,32,2,nomma",
           "k2w:1,64,64,4,4", "k2w:1,64,64,4,4,noload", "k2w:1,64,64,4,4,nomma")
_MMA = re.compile(r"hopper::mma_bf16\(acc\[i\]\[j\], af\[i\], bfr\[j >> 1\]\[\(j & 1\) \* 2\],"
                  r"\s*bfr\[j >> 1\]\[\(j & 1\) \* 2 \+ 1\]\);")
_FETCH = "    fetch(t + kStages - 1);\n"


def parse(variant: str):
    """``"k2:8,32,2,noload"`` -> ("k2", (8, 32, 2), "noload")."""
    kernel, _, rest = variant.partition(":")
    parts = rest.split(",")
    diag = parts[-1] if parts[-1] in ("noload", "nomma") else None
    values = tuple(int(p) for p in (parts[:-1] if diag else parts))
    if kernel not in CONSTANTS or len(values) != len(CONSTANTS[kernel][1]):
        raise ValueError(f"bad variant {variant!r}")
    return kernel, values, diag


def variant_source(kernel: str, values, diag=None) -> str:
    """The kernel's source with its tile constants set and the diagnostic
    applied; raises if a pattern is missing from the source."""
    src, names = CONSTANTS[kernel]
    text = (_kernels.CSRC / f"{src}.cu").read_text()
    for name, value in zip(names, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise ValueError(f"{src}.cu: constant {name} not found once")
    if diag == "noload":
        if text.count(_FETCH) != 1:
            raise ValueError(f"{src}.cu: the main loop's fetch() not found once")
        text = text.replace(_FETCH, "")
    elif diag == "nomma":
        text, n = _MMA.subn("acc[i][j][0] += __uint_as_float(af[i][0] ^ bfr[j >> 1][0]);", text)
        if n != 1:
            raise ValueError(f"{src}.cu: the mma call not found once")
    return text


def _build(variant: str) -> Path:
    kernel, values, diag = parse(variant)
    out = _kernels.BUILD_DIR.parent / "conv_tiles"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / (variant.replace(":", "_").replace(",", "_") + ".cu")
    cu.write_text(variant_source(kernel, values, diag))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.CSRC), "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {variant}:\n{proc.stdout}{proc.stderr}")
    return so


def _ms(fn):
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def run(variants=DEFAULT, device=None):
    """One dict a (variant, shape): variant, shape, ms, tflops, ok."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    with ThreadPoolExecutor(len(variants)) as ex:
        libs = dict(zip(variants, ex.map(_build, variants)))
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for b, h, w, cin, cout in SHAPES:
        x = torch.randn((b, h, w, cin), device=dev, generator=gen).to(torch.bfloat16)
        wt = (torch.randn((3, 3, cin, cout), device=dev, generator=gen) / math.sqrt(9 * cin))
        wt = wt.to(torch.bfloat16)
        g = torch.randn((b, h, w, cout), device=dev, generator=gen).to(torch.bfloat16)
        refs = {}
        for variant, so in libs.items():
            kernel, values, diag = parse(variant)
            lib = ctypes.CDLL(str(so))
            for fn, (res, args) in _kernels.SIGNATURES[CONSTANTS[kernel][0]].items():
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, list(args)
            if kernel == "k2":
                y = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)

                def call():
                    return lib.k2_conv3x3_bf16(x.data_ptr(), wt.data_ptr(), y.data_ptr(), b, h, w,
                                               cin, cout, stream)
                if "k2" not in refs:
                    want = conv2d.conv3x3_plain(x, wt).float()
                    absref = conv2d.conv3x3_plain(x.float().abs(), wt.float().abs())
                    refs["k2"] = (want, 1e-5 * absref + 2.0 ** -7 * want.abs())
                out = y
            else:
                dy, ci, co = values[:3]
                steps = b * h * -(-w // conv2d.WGRAD_SEGMENT)
                tiles = 3 // dy * -(-cin // ci) * -(-cout // co)
                chunks = max(1, min(lib.k2w_resident_blocks_bf16() // tiles, steps))
                per = -(-steps // chunks)
                chunks = -(-steps // per)
                part = torch.empty((chunks, 3, 3, cin, cout), device=dev)
                out = torch.empty((3, 3, cin, cout), device=dev)

                def call():
                    return lib.k2w_conv3x3_wgrad_bf16(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                                      out.data_ptr(), b, h, w, cin, cout, chunks,
                                                      per, stream)
                if "k2w" not in refs:
                    want = conv2d.conv3x3_wgrad_plain(x, g)
                    absref = conv2d.conv3x3_wgrad_plain(x.float().abs(), g.float().abs())
                    refs["k2w"] = (want, 1e-5 * absref + 2.0 ** -8 * want.abs())
            _kernels.check(call(), variant)
            torch.cuda.synchronize()
            want, tol = refs[kernel]
            ok = bool(((out.float() - want).abs() <= tol).all())
            ms = _ms(call)
            rows.append(dict(variant=variant, shape=(b, h, w, cin, cout), ms=ms,
                             tflops=2 * 9 * cin * cout * b * h * w / ms / 1e9, ok=ok))
        del refs
    return rows


def main(argv=None):
    rows = run(tuple(argv) if argv else DEFAULT)
    print(f"card: {torch.cuda.get_device_name(0)}")
    for r in rows:
        print(f"{r['variant']:<28} {r['shape']}: {r['ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
              f"{'ok' if r['ok'] else 'WRONG'}")


if __name__ == "__main__":
    main(sys.argv[1:])
