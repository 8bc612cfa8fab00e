"""Tile sweep of the tensor-core K2 and K2w (bf16 and f32), of T1-T4, and of
K1, K3 and K4, on the card.

    python -m com_tpu_torch.tools.perf.conv_tiles [VARIANT ...]

Builds copies of ``csrc/conv3x3.cu`` / ``csrc/conv3x3_wgrad.cu`` with their
tile constants replaced and times each bf16 entry point at the backbone's
three shapes (2,468,468,64->64), (2,234,234,128->128), (2,117,117,256->256),
and each f32 entry point at path T's (2,200,176,256->128),
(2,200,176,128->128), (2,100,88,256->256) and path U.2's (CaDDN)
(2,188,140,64->64), (2,94,70,128->128), (2,47,35,256->256), against the
plain version.  A variant names the kernel and its constants, with an
optional diagnostic:

  k2:TR,KC,STAGES              kTR, kKc, kStages of conv3x3.cu
  k2w:DY,CI,CO,WARPS_M,STAGES  kDY, kCi, kCo, kWarpsM, kStages of conv3x3_wgrad.cu
  k2f:STAGES,ABUFS,WIDE        kFStages, kFABufs, kFWideItems of conv3x3.cu (f32;
                               WIDE 0: always 4 warpgroups a block, a large
                               number: always 2)
  k2wf:STAGES,ABUFS            kFStages, kFABufs of conv3x3_wgrad.cu (f32)
  ...,noload                   stages loaded only before the main loop (the
                               products run on stale data): the time without
                               the loads
  ...,nomma                    each mma.sync (f32: each three-pass product)
                               replaced by one add of its fragments' bits:
                               the time without the products
  ...,nosplit                  (f32) the fragments passed unsplit, hi = lo =
                               the f32 value: the time without the TF32 splits
  ...,inacc                    (f32) the products summed in the tensor cores'
                               accumulators for the whole call, without the
                               stages' round-to-nearest adds: its pos_err
                               (the largest and the mean relative error on
                               |x|, |w| against f64, printed for every f32
                               variant) shows their rounding toward zero
  t1:STAGES                    kStages (T1's, T2's and T4's ring),
  t2:WARPS_M,STAGES            kXcolWarpsM (T2's warps along M), and
  t3:STAGES                    kGt9Stages (T3's ring) of wgrad_variants.cu
  t4:STAGES                    (its 64-channel tiles are fixed by the
  ...,noload | ,nomma          128-byte swizzled rows of wgmma), timed at the
  | ,nocol (not T3)            wgrad sweep's shapes (2,468,468,64->64) and
  | ,viewbase (T3)             (2,468,468,128->64), th 8 and 16 (diagnostics as
                               above, T1's, T3's and T4's nomma dropping their
                               wgmma; ,nocol: no column buffer copied, the
                               products read a stale one; ,viewbase: T3's view
                               descriptors with the base-offset field taken
                               from the view's start address instead of the
                               swizzle pattern's, the other reading of the
                               PTX ISA's rule, which the ok column judges)
  k1:FWD,BWD,THREADS,MINB      kFwdRows, kBwdRows, kThreads, kMinBlocks of
  ...,noload | ,noscan         seg_scan.cu (diagnostics: k1_main without its
  | ,mainonly                  loads, without the scans across its threads,
                               or alone, without k1_carries and k1_fixup:
                               what any one-launch design doing k1_main's
                               reads would cost), timed on K1's path shapes (sum
                               f32 (2,163840,8), max bf16 (2,163840,32) and
                               its backward) over Waymo-like pillar ids: two
                               scenes, and sample 1 one whole-sample run
  k4:THREADS,PACK_THREADS      kThreads, kPackThreads of nms.cu (the sweep's
                               block, a pack block), timed on NMS-like,
                               none-suppressed and all-suppressed-by-the-first
                               (2, K, K) at K = 500 and 1024, and (4, 4096,
                               4096), the sweep's rows read from L2
  k3:TILEH,OBJS                kTileH, kObjs of stamp.cu, timed in both modes
  ...,noexp | ,nocells         on the training path's (2,3,468,468) canvas
                               (diagnostics: the gaussian's exp replaced by a
                               constant; no cell computed, leaving the object
                               loads, the compaction and the canvas write)

Without arguments it runs the shipped tiles and the diagnostics of each
(bf16 and f32), six other sets of the f32 kernels' constants,
T1-T4's shipped constants, their diagnostics, T3's other base offset and
other stage counts of each, K1's shipped constants, its three diagnostics and four other sets, and
four sets each of K4 and K3 (the first of each the shipped one).
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
from com_tpu_torch.tools.perf import microbench_wgrad_kernels as wgrad_sweep
from com_tpu_torch.utils.device import resolve_device

SHAPES = ((2, 468, 468, 64, 64), (2, 234, 234, 128, 128), (2, 117, 117, 256, 256))
ITERS = 20
F32_SHAPES = ((2, 200, 176, 256, 128), (2, 200, 176, 128, 128), (2, 100, 88, 256, 256),
              (2, 188, 140, 64, 64), (2, 94, 70, 128, 128), (2, 47, 35, 256, 256))
CONSTANTS = {"k2": ("conv3x3", ("kTR", "kKc", "kStages")),
             "k2w": ("conv3x3_wgrad", ("kDY", "kCi", "kCo", "kWarpsM", "kStages")),
             "k2f": ("conv3x3", ("kFStages", "kFABufs", "kFWideItems")),
             "k2wf": ("conv3x3_wgrad", ("kFStages", "kFABufs")),
             "k1": ("seg_scan", ("kFwdRows", "kBwdRows", "kThreads", "kMinBlocks")),
             "k4": ("nms", ("kThreads", "kPackThreads")),
             "k3": ("stamp", ("kTileH", "kObjs")),
             "t1": ("wgrad_variants", ("kStages",)),
             "t2": ("wgrad_variants", ("kXcolWarpsM", "kStages")),
             "t3": ("wgrad_variants", ("kGt9Stages",)),
             "t4": ("wgrad_variants", ("kStages",))}
DEFAULT = ("k2:8,32,2", "k2:8,32,2,noload", "k2:8,32,2,nomma",
           "k2w:1,64,64,4,4", "k2w:1,64,64,4,4,noload", "k2w:1,64,64,4,4,nomma")
F32_DEFAULT = ("k2f:2,3,3", "k2f:2,3,3,noload", "k2f:2,3,3,nomma", "k2f:2,3,3,nosplit",
               "k2f:2,3,3,inacc", "k2f:2,3,0", "k2f:2,3,1000000", "k2f:3,3,3", "k2f:2,2,3",
               "k2wf:2,3", "k2wf:2,3,noload", "k2wf:2,3,nomma", "k2wf:2,3,nosplit",
               "k2wf:2,3,inacc", "k2wf:3,3", "k2wf:2,2")
F32_SHIPPED = ("k2f:2,3,3", "k2wf:2,3")
K1_DEFAULT = ("k1:8,4,256,2", "k1:8,4,256,2,noload", "k1:8,4,256,2,noscan",
              "k1:8,4,256,2,mainonly", "k1:8,4,256,1", "k1:16,8,256,1", "k1:4,4,256,3",
              "k1:8,4,128,4")
K1_POINTS = 163840
K4_DEFAULT = ("k4:512,512", "k4:1024,256", "k4:256,256", "k4:1024,128")
K3_DEFAULT = ("k3:16,2", "k3:16,2,noexp", "k3:16,2,nocells", "k3:32,2", "k3:16,1")
T_DEFAULT = ("t1:3", "t1:3,noload", "t1:3,nomma", "t1:3,nocol", "t1:4",
             "t2:4,3", "t2:4,3,noload", "t2:4,3,nomma", "t2:4,3,nocol", "t2:2,3", "t2:4,4",
             "t3:3", "t3:3,noload", "t3:3,nomma", "t3:3,viewbase", "t3:2", "t3:4", "t3:6",
             "t4:3", "t4:3,noload", "t4:3,nomma", "t4:3,nocol", "t4:4")
T_SHIPPED = ("t1:3", "t2:4,3", "t3:3", "t4:3")
DIAGS = {"k1": ("noload", "noscan", "mainonly"), "k2": ("noload", "nomma"),
         "k2w": ("noload", "nomma"), "k2f": ("noload", "nomma", "nosplit", "inacc"),
         "k2wf": ("noload", "nomma", "nosplit", "inacc"), "k3": ("noexp", "nocells"), "k4": (),
         "t1": ("noload", "nomma", "nocol"), "t2": ("noload", "nomma", "nocol"),
         "t3": ("noload", "nomma", "viewbase"), "t4": ("noload", "nomma", "nocol")}
_K3_EXP = "exp2f((float)(dx * dx + dy * dy) * ob.v)"
_K3_CELLS = "    for (int q = 0; q < count; ++q) {\n"
_MMA = re.compile(r"hopper::mma_bf16\(acc\[i\]\[j\], af\[i\], bfr\[j >> 1\]\[\(j & 1\) \* 2\],"
                  r"\s*bfr\[j >> 1\]\[\(j & 1\) \* 2 \+ 1\]\);")
_FETCH = "    fetch(t + kStages - 1);\n"
# the f32 kernels' diagnostics: the main loop's fetch, the three-pass
# product (replaced by an add of its register fragments' bits, so that no
# load or split goes unused), the split (a local one passing the value
# unsplit)
_F32_FETCH = "    fetch(t + kFStages - 1);\n"
_F32_MMA = {  # the product's call in each f32 kernel, and its replacement
    k: (f"hopper::wgmma_3xtf32(part, a_hi[b], a_lo[b], d_hi + off, d_lo + off, {i} > 0);",
        "part[0] += __uint_as_float(a_hi[b][0] ^ a_hi[b][1] ^ a_hi[b][2] ^ a_hi[b][3] ^ "
        "a_lo[b][0] ^ a_lo[b][1] ^ a_lo[b][2] ^ a_lo[b][3] ^ (uint32_t)(d_hi ^ d_lo));")
    for k, i in (("k2f", "tap"), ("k2wf", "ks"))}
_F32_FLUSH = "    for (int i = 0; i < 32; ++i) acc[i] += part[i];\n"  # a stage's sums into acc
_F32_SPLIT = "hopper::split_tf32("
_F32_NOSPLIT = ('#include "hopper.cuh"\n\n__device__ __forceinline__ void nosplit_tf32(float v, '
                'uint32_t& hi, uint32_t& lo) { hi = lo = __float_as_uint(v); }\n')
# T1-T4's diagnostics: (line of the kernel, its replacement); T1 and T4
# share one templated kernel, so their lines are the same
_GTCOL_DIAGS = {
    "noload": ("    load(t + kStages - 1);\n", ""),
    "nocol": ("    build_cols(t + 1);\n", ""),
    "nomma": ("wgmma_m64n64k16(acc, wg_desc(ps + kk * 64), wg_desc(cs + kk * 64));",
              "acc[0] += __uint_as_float((uint32_t)(wg_desc(ps + kk * 64) ^ "
              "wg_desc(cs + kk * 64)));")}
_T_DIAGS = {
    "t1": _GTCOL_DIAGS,
    "t2": {"noload": (_FETCH, ""), "nocol": ("    build_col(t + 1);\n", "")},
    "t3": {"noload": ("    load(t + kGt9Stages - 1);\n", ""),
           "nomma": ("wgmma_m64n64k16(acc, wg_desc(ps + kk * 64), wg_desc_rows(hs, wg + kk));",
                     "acc[0] += __uint_as_float((uint32_t)(wg_desc(ps + kk * 64) ^ "
                     "wg_desc_rows(hs, wg + kk)));"),
           "viewbase": ("(uint64_t)((hopper::smem_addr(block) >> 7) & 7) << 49",
                        "(uint64_t)((hopper::smem_addr(block + row * 64) >> 7) & 7) << 49")},
    "t4": _GTCOL_DIAGS}
_K1_FETCH = "    if (g.active && r < g.nv) task.fetch(row0 + r, g.c0, C, vec, raw[k]);\n"
_K1_SCAN = re.compile(r"  block_scans<Op, VEC, kWarps>\(g, [^;]*;\n")
_K1_LAUNCHES = "  if (err != cudaSuccess) return (int)err;\n  // k1_carries and k1_fixup start"


def parse(variant: str):
    """``"k2:8,32,2,noload"`` -> ("k2", (8, 32, 2), "noload")."""
    kernel, _, rest = variant.partition(":")
    parts = rest.split(",")
    diag = parts[-1] if parts[-1] in {d for ds in DIAGS.values() for d in ds} else None
    values = tuple(int(p) for p in (parts[:-1] if diag else parts))
    if (kernel not in CONSTANTS or len(values) != len(CONSTANTS[kernel][1])
            or diag not in (None, *DIAGS[kernel])):
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
    if kernel in ("k2f", "k2wf") and diag:
        if diag == "noload":
            old, new, n = _F32_FETCH, "", text.count(_F32_FETCH)
            text = text.replace(old, new)
        elif diag == "nomma":
            old, new = _F32_MMA[kernel]
            n = text.count(old)
            text = text.replace(old, new)
        elif diag == "inacc":
            old = _F32_MMA[kernel][0]
            n = min(text.count(old), text.count(_F32_FLUSH))
            text = text.replace(old, old.replace("(part,", "(acc,").rsplit(",", 1)[0] + ", 1);")
            text = text.replace(_F32_FLUSH, "")
        else:  # nosplit
            n = text.count('#include "hopper.cuh"\n')
            text = text.replace('#include "hopper.cuh"\n', _F32_NOSPLIT)
            text = text.replace(_F32_SPLIT, "nosplit_tf32(")
        if n != 1:
            raise ValueError(f"{src}.cu: the f32 kernel's {diag} pattern not found once")
    elif diag in _T_DIAGS.get(kernel, {}):
        old, new = _T_DIAGS[kernel][diag]
        if text.count(old) != 1:
            raise ValueError(f"{src}.cu: {old.strip()!r} not found once")
        text = text.replace(old, new)
    elif kernel == "k1" and diag == "noload":
        if text.count(_K1_FETCH) != 1:
            raise ValueError(f"{src}.cu: k1_main's fetch not found once")
        text = text.replace(_K1_FETCH, "")
    elif diag == "noscan":
        text, n = _K1_SCAN.subn("  eid = rid = INT_MIN;\n  for (int i = 0; i < VEC; ++i) "
                                "ev[i] = rv[i] = Op::ident();\n", text)
        if n != 1:
            raise ValueError(f"{src}.cu: k1_main's block_scans not found once")
    elif diag == "mainonly":
        if text.count(_K1_LAUNCHES) != 1:
            raise ValueError(f"{src}.cu: the launches after k1_main not found once")
        text = text.replace(_K1_LAUNCHES, "  return (int)err;\n  // k1_carries and k1_fixup start")
    elif diag in ("noexp", "nocells"):  # K3 without the gaussian's exp, or without the cells' loop
        old, new = ((_K3_EXP, "ob.v") if diag == "noexp"
                    else (_K3_CELLS, _K3_CELLS.replace("q < count", "q < 0")))
        if text.count(old) != 1:
            raise ValueError(f"{src}.cu: {old.strip()!r} not found once")
        text = text.replace(old, new)
    elif diag == "noload":
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


def call_ms(fn, iters=ITERS, queued=False):
    """Mean ms a call over ``iters`` calls after two warm-up calls (CUDA
    events); ``queued``: the calls wait behind a spin kernel, so that the
    card never waits for the host's launches (the device time of a call
    shorter than its launch)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(iters * 200_000)  # ~0.1 ms a call at the SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run(variants=DEFAULT, device=None):
    """One dict a (variant, shape): variant, shape, ms, tflops, ok.  bf16
    variants (k2, k2w) at ``SHAPES``, f32 ones (k2f, k2wf) at
    ``F32_SHAPES``; ok: within ``chip_smoke.py``'s tolerance of the plain
    version (f32: 1e-5 * the conv of |x| and |w|, no rounding allowance)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    libs = _load_conv(variants)
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for dt, shapes, kinds in ((torch.bfloat16, SHAPES, ("k2", "k2w")),
                              (torch.float32, F32_SHAPES, ("k2f", "k2wf"))):
        mine = {v: lib for v, lib in libs.items() if v.split(":")[0] in kinds}
        if not mine:
            continue
        f32 = dt == torch.float32
        rnd = 0.0 if f32 else 2.0 ** -7
        for b, h, w, cin, cout in shapes:
            x = torch.randn((b, h, w, cin), device=dev, generator=gen).to(dt)
            wt = (torch.randn((3, 3, cin, cout), device=dev, generator=gen) / math.sqrt(9 * cin))
            wt = wt.to(dt)
            g = torch.randn((b, h, w, cout), device=dev, generator=gen).to(dt)
            refs = {}
            for variant, lib in mine.items():
                kernel = variant.split(":")[0]
                if kernel in ("k2", "k2f"):
                    y = torch.empty((b, h, w, cout), dtype=dt, device=dev)
                    entry = lib.k2_conv3x3_f32 if f32 else lib.k2_conv3x3_bf16
                    # the f32 kernel's K-major w (a copy)
                    wk = wt.transpose(2, 3).contiguous() if f32 else wt

                    def call():
                        return entry(x.data_ptr(), wk.data_ptr(), y.data_ptr(), b, h, w, cin,
                                     cout, stream)
                    if "k2" not in refs:
                        want = conv2d.conv3x3_plain(x, wt).float()
                        absref = conv2d.conv3x3_plain(x.float().abs(), wt.float().abs())
                        refs["k2"] = (want, 1e-5 * absref + rnd * want.abs())
                    out, ref = y, "k2"
                else:
                    if f32:
                        chunks, per = conv2d.wgrad_plan(b, h, w, cin, cout,
                                                        lib.k2w_resident_blocks_f32(), dt)
                    else:  # one wave of the variant's own tiles
                        dy, ci, co = parse(variant)[1][:3]
                        steps = b * h * -(-w // conv2d.WGRAD_SEGMENT)
                        tiles = 3 // dy * -(-cin // ci) * -(-cout // co)
                        chunks = max(1, min(lib.k2w_resident_blocks_bf16() // tiles, steps))
                        per = -(-steps // chunks)
                        chunks = -(-steps // per)
                    part = torch.empty((chunks, 3, 3, cin, cout), device=dev)
                    out = torch.empty((3, 3, cin, cout), device=dev)
                    args = (chunks,) if f32 else (chunks, per)
                    entry = lib.k2w_conv3x3_wgrad_f32 if f32 else lib.k2w_conv3x3_wgrad_bf16

                    def call():
                        return entry(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                                     b, h, w, cin, cout, *args, stream)
                    if "k2w" not in refs:
                        want = conv2d.conv3x3_wgrad_plain(x, g)
                        absref = conv2d.conv3x3_wgrad_plain(x.float().abs(), g.float().abs())
                        refs["k2w"] = (want, 1e-5 * absref + rnd / 2 * want.abs())
                    ref = "k2w"
                _kernels.check(call(), variant)
                torch.cuda.synchronize()
                want, tol = refs[ref]
                ok = bool(((out.float() - want).abs() <= tol).all())
                ms = call_ms(call)
                row = dict(variant=variant, shape=(b, h, w, cin, cout), ms=ms,
                           tflops=2 * 9 * cin * cout * b * h * w / ms / 1e9, ok=ok)
                if f32:  # the same call on |x|, |w|, |g| (one-signed sums) against f64
                    saved = [a.clone() for a in (x, wt, g)]
                    for a in (x, wt, g):
                        a.abs_()
                    if ref == "k2":
                        wk.copy_(wt.transpose(2, 3))
                        want = conv2d.conv3x3_plain(x.double(), wt.double())
                    else:
                        want = conv2d.conv3x3_wgrad_plain(x.double(), g.double())
                    _kernels.check(call(), variant)
                    torch.cuda.synchronize()
                    rel = (out.double() - want) / want.abs().clamp_min(1e-30)
                    row["pos_err"] = (float(rel.abs().max()), float(rel.mean()))
                    for a, v in zip((x, wt, g), saved):
                        a.copy_(v)
                    if ref == "k2":
                        wk.copy_(wt.transpose(2, 3))
                    del want, rel, saved
                rows.append(row)
            del refs
    return rows


def _load_conv(variants):
    """Each conv variant built and loaded with its source's C signatures."""
    by_src = {}
    for v in variants:
        by_src.setdefault(CONSTANTS[parse(v)[0]][0], []).append(v)
    return {v: lib for src, vs in by_src.items() for v, lib in _load(tuple(vs), src).items()}


def run_t(variants=T_DEFAULT, device=None):
    """One dict a (variant, shape, th): variant, shape, th, chunks (of the
    plan for the variant's own resident blocks), ms (calls as the host
    issues them), device_ms (queued behind a spin kernel), tflops (of
    device_ms), ok (within the sweep's 1e-5 * sum |x||g| of the plain
    version)."""
    from com_tpu_torch.ops import wgrad_variants as wv

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    libs = _load(variants, "wgrad_variants")
    names = {prefix: name for name, prefix in wv.PREFIX.items()}  # "t1" -> "gcol"
    gen = torch.Generator(device=dev).manual_seed(11)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for b, h, w, cin, cout in wgrad_sweep.SHAPES:
        x = (torch.randn((b, h, w, cin), device=dev, generator=gen) * 0.3).to(torch.bfloat16)
        g = (torch.randn((b, h, w, cout), device=dev, generator=gen) * 0.3).to(torch.bfloat16)
        tol = wgrad_sweep.TOL * wv.oracle(x.abs(), g.abs())
        flops = 2 * 9 * cin * cout * b * h * w
        for th in wgrad_sweep.THS:
            kernels = {v.split(":")[0] for v in libs}
            want = {k: wv.VARIANTS[names[k]][1](x, g, th) for k in kernels}
            for variant, lib in libs.items():
                kernel = variant.split(":")[0]
                entry = getattr(lib, f"{kernel}_wgrad_{names[kernel]}")
                resident = getattr(lib, f"{kernel}_resident_blocks")()
                chunks, tiles, segs = wv.xcol_gtcol_plan(b, h, w, cin, cout, th, resident)
                part = torch.empty((chunks, 9 * cin * cout), device=dev)
                out = torch.empty((3, 3, cin, cout), device=dev)

                def call():
                    return entry(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), b,
                                 h, w, cin, cout, th, tiles, segs, stream)

                _kernels.check(call(), variant)
                torch.cuda.synchronize()
                ok = bool(((out - want[kernel]).abs() <= tol).all())
                dms = call_ms(call, queued=True)
                rows.append(dict(variant=variant, shape=(b, h, w, cin, cout), th=th,
                                 chunks=chunks, ms=call_ms(call), device_ms=dms,
                                 tflops=flops / dms / 1e9, ok=ok))
            del want
    return rows


def _scene_ids(gen, b, n, dev):
    """Pillar ids of Waymo-like scenes, sorted: three quarters of the points
    with a 1/r falloff over the 149.76 m square, a quarter in 32 blobs of
    1.2 m; 0.32 m pillars on the 468 x 468 grid."""
    half, size = 74.88, 468
    r = half * torch.rand((b, n), device=dev, generator=gen) ** 0.75
    th = (torch.rand((b, n), device=dev, generator=gen) * 2 - 1) * math.pi
    xy = torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
    nb = n // 4
    centers = (torch.rand((b, 32, 2), device=dev, generator=gen) * 2 - 1) * half * 0.8
    pick = torch.randint(0, 32, (b, nb), device=dev, generator=gen)
    xy[:, :nb] = (torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
                  + 1.2 * torch.randn((b, nb, 2), device=dev, generator=gen))
    cell = ((xy + half) / 0.32).floor().clamp(0, size - 1).to(torch.int32)
    return torch.sort(cell[..., 1] * size + cell[..., 0], dim=1).values.contiguous()


def run_k1(variants=K1_DEFAULT, device=None):
    """One dict a (variant, input, function): variant, input, fn, ms (calls
    as the host issues them), device_ms (queued behind a spin kernel), ok."""
    from com_tpu_torch.ops import seg_scan

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    libs = _load(variants, "seg_scan")
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scenes = _scene_ids(gen, 2, K1_POINTS, dev)
    padded = scenes.clone()
    padded[1] = 468 * 468
    x8 = torch.randn((2, K1_POINTS, 8), device=dev, generator=gen)
    x32 = torch.randn((2, K1_POINTS, 32), device=dev, generator=gen).to(torch.bfloat16)
    x32 = (x32.float() * 2).round().to(torch.bfloat16) / 2  # coarse: tied maxima
    g32 = torch.randn((2, K1_POINTS, 32), device=dev, generator=gen).to(torch.bfloat16)
    rows = []
    for where, seg in (("two scenes", scenes), ("whole-sample run", padded)):
        out32 = seg_scan.run_bcast_plain(x32, seg, "max")
        cases = {"sum f32 (2,163840,8)": (0, x8, seg_scan.run_bcast_plain(x8, seg, "sum")),
                 "max bf16 (2,163840,32)": (1, x32, out32),
                 "max backward bf16 (2,163840,32)":
                     (2, x32, seg_scan.run_bcast_max_bwd_plain(g32, x32, out32, seg))}
        sum_tol = 1e-5 * seg_scan.run_bcast_plain(x8.abs(), seg, "sum") + 1e-6
        bwd_tol = (1e-5 * seg_scan.run_bcast_plain(g32.float().abs(), seg, "sum")
                   + 2.0 ** -7 * cases["max backward bf16 (2,163840,32)"][2].float().abs() + 1e-6)
        for variant, lib in libs.items():
            for name, (op, x, want) in cases.items():
                b, n, c = x.shape
                dt = int(x.dtype == torch.bfloat16)
                scratch = seg_scan._scratch(x, op, lib.k1_tile_rows(c, dt, op))
                y = torch.empty_like(x)
                gp, fp = (g32.data_ptr(), out32.data_ptr()) if op == 2 else (None, None)

                def call():
                    return lib.k1_call(gp, x.data_ptr(), fp, seg.data_ptr(), y.data_ptr(),
                                       scratch.data_ptr(), b, n, c, op, dt, stream)

                _kernels.check(call(), variant)
                torch.cuda.synchronize()
                err = (y.float() - want.float()).abs()
                ok = (torch.equal(y, want) if op == 1 else
                      bool((err <= (sum_tol if op == 0 else bwd_tol)).all()))
                rows.append(dict(variant=variant, input=where, fn=name, ms=call_ms(call),
                                 device_ms=call_ms(call, queued=True), ok=ok))
    return rows


def _load(variants, name):
    """Each variant built and loaded with csrc/<name>.cu's C signatures."""
    with ThreadPoolExecutor(len(variants)) as ex:
        paths = dict(zip(variants, ex.map(_build, variants)))
    libs = {}
    for variant, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn, (res, args) in _kernels.SIGNATURES[name].items():
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, list(args)
        libs[variant] = lib
    return libs


def k4_cases(dev, gen, b=2, k=500):
    """K4's inputs, (b, k, k) over with its diagonal set (a box overlaps
    itself): NMS-like, ~60 % valid, a candidate overlapping those within 1.5
    m among 500 spread over 40 m; all valid with nothing suppressed; all
    valid with everything suppressed by the first."""
    eye = torch.eye(k, dtype=torch.bool, device=dev).expand(b, k, k)
    xy = torch.rand((b, k, 2), device=dev, generator=gen) * 40
    near = (xy[:, :, None] - xy[:, None]).pow(2).sum(-1) < 1.5 ** 2
    ones = torch.ones((b, k), dtype=torch.bool, device=dev)
    first = eye.clone()
    first[:, 0] = True
    return {f"NMS-like ({b},{k},{k})": (near.contiguous(),
                                        torch.rand((b, k), device=dev, generator=gen) < 0.6),
            f"none suppressed ({b},{k},{k})": (eye.contiguous(), ones),
            f"all suppressed by the first ({b},{k},{k})": (first, ones)}


def run_k4(variants=K4_DEFAULT, device=None):
    """One dict a (variant, case): variant, case, ms, device_ms, ok (keep
    masks equal to greedy_suppress_plain's)."""
    from com_tpu_torch.ops import nms

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    libs = _load(variants, "nms")
    gen = torch.Generator(device=dev).manual_seed(7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {**k4_cases(dev, gen), **k4_cases(dev, gen, k=1024),
             **k4_cases(dev, gen, b=4, k=4096)}
    rows = []
    for case, (over, valid) in cases.items():
        want = nms.greedy_suppress_plain(over, valid)
        b, k = valid.shape
        packed = torch.empty((b, k, -(-k // 64) | 1), dtype=torch.int64, device=dev)
        for variant, lib in libs.items():
            keep = torch.empty_like(valid)

            def call():
                return lib.k4_greedy_suppress(over.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                                              packed.data_ptr(), b, k, stream)

            _kernels.check(call(), variant)
            torch.cuda.synchronize()
            rows.append(dict(variant=variant, case=case, ms=call_ms(call),
                             device_ms=call_ms(call, queued=True),
                             ok=torch.equal(keep, want)))
    return rows


def k3_case(dev, gen, b=2, n=500, c=3, h=468, w=468, real=100):
    """K3's inputs on the training path's canvas: ``real`` valid objects of
    radii 2-23 a sample among ``n`` slots, 20 of them on the centers of 20
    others, class ids int64 (as the COM loss holds them)."""
    centers = torch.stack([torch.randint(0, w, (b, n), device=dev, generator=gen),
                           torch.randint(0, h, (b, n), device=dev, generator=gen)], -1)
    centers[:, :20] = centers[:, 20:40]
    radii = torch.randint(2, 24, (b, n), device=dev, generator=gen, dtype=torch.int32)
    cls = torch.randint(0, c, (b, n), device=dev, generator=gen)
    values = torch.rand((b, n), device=dev, generator=gen) + 0.5
    valid = torch.zeros((b, n), dtype=torch.bool, device=dev)
    valid[:, :real] = True
    return centers.to(torch.int32).contiguous(), radii, cls, values, valid, (c, h, w)


def run_k3(variants=K3_DEFAULT, device=None):
    """One dict a (variant, mode): variant, mode, ms, device_ms, ok (gauss
    within 2e-6 of stamp_windows_plain, last_wins exact)."""
    from com_tpu_torch.ops import stamp

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("conv_tiles times kernels: it needs a CUDA device")
    libs = _load(variants, "stamp")
    gen = torch.Generator(device=dev).manual_seed(9)
    stream = torch.cuda.current_stream(dev).cuda_stream
    centers, radii, cls, values, valid, (c, h, w) = k3_case(dev, gen)
    b, n = radii.shape
    rows = []
    for mode, code, fill in (("gauss", 0, 0.0), ("last_wins", 1, 1.0)):
        want = stamp.stamp_windows_plain(centers, radii, cls, values, valid, c, h, w, mode, fill)
        for variant, lib in libs.items():
            out = torch.empty((b, c, h, w), device=dev)

            def call():
                return lib.k3_stamp(centers.data_ptr(), radii.data_ptr(), cls.data_ptr(),
                                    values.data_ptr(), valid.data_ptr(), out.data_ptr(), b, n, c,
                                    h, w, 16, code, 4, fill, stream)

            _kernels.check(call(), variant)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            rows.append(dict(variant=variant, mode=mode, ms=call_ms(call),
                             device_ms=call_ms(call, queued=True),
                             ok=err <= 2e-6 if mode == "gauss" else err == 0.0))
    return rows


def main(argv=None):
    variants = (tuple(argv) if argv
                else DEFAULT + F32_DEFAULT + T_DEFAULT + K1_DEFAULT + K4_DEFAULT + K3_DEFAULT)
    by = {k: tuple(v for v in variants if v.split(":")[0] == k) for k in ("k1", "k3", "k4")}
    tvs = tuple(v for v in variants if v.split(":")[0] in _T_DIAGS)
    conv = tuple(v for v in variants if v.split(":")[0] in ("k2", "k2w", "k2f", "k2wf"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi or torch.cuda.get_device_name(0)}")
    for r in run(conv) if conv else ():
        pos = (f"; pos_err {r['pos_err'][0]:.2e} max, {r['pos_err'][1]:.2e} mean"
               if "pos_err" in r else "")
        print(f"{r['variant']:<28} {r['shape']}: {r['ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
              f"{'ok' if r['ok'] else 'WRONG'}{pos}")
    for r in run_t(tvs) if tvs else ():
        print(f"{r['variant']:<22} {r['shape']} th={r['th']:<2} {r['chunks']:>4} chunks: "
              f"{r['ms']:.4f} ms, queued {r['device_ms']:.4f} ms {r['tflops']:.1f} TFLOP/s "
              f"{'ok' if r['ok'] else 'WRONG'}")
    for r in run_k1(by["k1"]) if by["k1"] else ():
        print(f"{r['variant']:<16} {r['fn']:<32} {r['input']:<17}: {r['ms']:.4f} ms, queued "
              f"{r['device_ms']:.4f} ms {'ok' if r['ok'] else 'WRONG'}")
    for r in run_k4(by["k4"]) if by["k4"] else ():
        print(f"{r['variant']:<14} {r['case']:<44}: {r['ms']:.4f} ms, queued "
              f"{r['device_ms']:.4f} ms {'ok' if r['ok'] else 'WRONG'}")
    for r in run_k3(by["k3"]) if by["k3"] else ():
        print(f"{r['variant']:<10} stamp {r['mode']:<10} (2,3,468,468) 500 slots: {r['ms']:.4f} "
              f"ms, queued {r['device_ms']:.4f} ms {'ok' if r['ok'] else 'WRONG'}")


if __name__ == "__main__":
    main(sys.argv[1:])
