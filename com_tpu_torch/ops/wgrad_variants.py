"""Four formulations of the 3x3 conv weight gradient (kernels T1-T4).

Counterpart of the kernels of ``tools/perf/microbench_wgrad_kernels.py``,
the JAX package's sweep of ways to hand the weight gradient of K2w,

    dw[dy, dx, ci, co] = sum_{b,h,w} xpad[b, h+dy, w+dx, ci] * g[b, h, w, co],

to a matrix unit.  Each works over row tiles of ``th`` rows (H zero-padded
to a multiple of ``th``) and sums the tiles' f32 products:

- ``wgrad_gcol`` (T1): g shifted per tap into a column buffer, x^T (cin, K)
  . g_col (K, 9 cout) -> (cin, 9 cout);
- ``wgrad_xcol`` (T2): x shifted per tap into a column buffer, x_col^T
  (9 cin, K) . g (K, cout) -> (9 cin, cout);
- ``wgrad_gt9`` (T3): g^T (cout, K) once, nine products with x's shifted
  views -> (cout, 9 cin);
- ``wgrad_gtcol`` (T4): g^T once, one product with an x column buffer
  (K, 9 cin) -> (cout, 9 cin).

Each returns (3, 3, Cin, Cout) f32.  For a CUDA tensor the wrapper launches
its tensor-core kernel (bf16 only, ``csrc/wgrad_variants.cu``: one f32
partial a chunk of row tiles sized to the card by ``xcol_gtcol_plan``, then
a fixed-order sum of the partials); for a CPU tensor it runs its plain
version (``*_plain``), which follows the same formulation in f32 and takes
any float dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels

# kernel launches by each wrapper since the last reset
gcol_launches = 0
xcol_launches = 0
gt9_launches = 0
gtcol_launches = 0

MAX_CHANNELS = 256  # the sweep's limit
SEGMENT = 64  # pixels of a row segment, the kernels' step
_TAPS = [(dy, dx) for dy in range(3) for dx in range(3)]
# variant -> the prefix of its C entries, <prefix>_wgrad_<variant> and
# <prefix>_resident_blocks
PREFIX = {"gcol": "t1", "xcol": "t2", "gt9": "t3", "gtcol": "t4"}
_resident_blocks: dict[tuple[int, str], int] = {}  # (device, variant) -> blocks at once


def _shifted(t: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """t[b, h + dy - 1, w + dx - 1], zero off the map."""
    h, w = t.shape[1], t.shape[2]
    return F.pad(t, (0, 0, 1, 1, 1, 1))[:, dy:dy + h, dx:dx + w]


def _row_tiles(t: torch.Tensor, th: int) -> torch.Tensor:
    """(B, H, W, C) zero-padded to a multiple of ``th`` rows, as
    (B * H/th, th * W, C) row tiles."""
    b, h, w, c = t.shape
    hp = -(-h // th) * th
    return F.pad(t, (0, 0, 0, 0, 0, hp - h)).reshape(b * hp // th, th * w, c)


def wgrad_gcol_plain(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T1's formulation: g_col[p, tap*cout + co] = g[h + 1 - dy, w + 1 - dx, co]
    (``gpad[2-dy:, 2-dx:]``), one (cin, K) . (K, 9 cout) product a tile."""
    cin, cout = x.shape[-1], g.shape[-1]
    gf = g.float()
    g_col = torch.cat([_shifted(gf, 2 - dy, 2 - dx) for dy, dx in _TAPS], -1)
    dwt = (_row_tiles(x.float(), th).transpose(1, 2) @ _row_tiles(g_col, th)).sum(0)
    return dwt.reshape(cin, 3, 3, cout).permute(1, 2, 0, 3).contiguous()


def wgrad_xcol_plain(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T2's formulation: x_col[p, tap*cin + ci] = x[h + dy - 1, w + dx - 1, ci],
    one (9 cin, K) . (K, cout) product a tile."""
    cin, cout = x.shape[-1], g.shape[-1]
    xf = x.float()
    x_col = torch.cat([_shifted(xf, dy, dx) for dy, dx in _TAPS], -1)
    dwf = (_row_tiles(x_col, th).transpose(1, 2) @ _row_tiles(g.float(), th)).sum(0)
    return dwf.reshape(3, 3, cin, cout)


def wgrad_gt9_plain(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T3's formulation: g^T (cout, K) once a tile, then nine (cout, K) .
    (K, cin) products with x's shifted views, side by side in (cout, 9 cin)."""
    cin, cout = x.shape[-1], g.shape[-1]
    xf = x.float()
    g_t = _row_tiles(g.float(), th).transpose(1, 2)
    dwt = torch.cat([(g_t @ _row_tiles(_shifted(xf, dy, dx), th)).sum(0)
                     for dy, dx in _TAPS], 1)
    return dwt.reshape(cout, 3, 3, cin).permute(1, 2, 3, 0).contiguous()


def wgrad_gtcol_plain(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T4's formulation: g^T once a tile, one (cout, K) . (K, 9 cin) product
    with x's column buffer."""
    cin, cout = x.shape[-1], g.shape[-1]
    xf = x.float()
    x_col = torch.cat([_shifted(xf, dy, dx) for dy, dx in _TAPS], -1)
    g_t = _row_tiles(g.float(), th).transpose(1, 2)
    dwt = (g_t @ _row_tiles(x_col, th)).sum(0)
    return dwt.reshape(cout, 3, 3, cin).permute(1, 2, 3, 0).contiguous()


def oracle(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient as nine f32 einsums over the zero-padded x
    (``microbench_wgrad_kernels.py:235-244``)."""
    xf, gf = x.float(), g.float()
    return torch.stack([torch.stack([torch.einsum("bhwc,bhwd->cd", _shifted(xf, dy, dx), gf)
                                     for dx in range(3)]) for dy in range(3)])


def xcol_gtcol_plan(b: int, h: int, wd: int, cin: int, cout: int, th: int,
                    resident: int) -> tuple[int, int, int]:
    """(chunks, row tiles a chunk, row segments a chunk) of T1-T4.

    The pixels of the operand a kernel reads in place (x for T1, g for the
    others) are B * ceil(H / th) row tiles of th image rows (the TPU
    kernels' grid steps; the last of a sample may be shorter), each
    ceil(W / 64) row segments wide.  A chunk is a run of whole row tiles by a
    run of segments, with one f32 partial; the grid has 3 * ceil(Cin / 64) *
    ceil(Cout / 64) blocks a chunk.  Of the splits whose grid is at most one
    wave of the ``resident`` blocks the card holds at once, the plan takes
    the one with the fewest steps (rows x segments) in a chunk, then the
    fewest chunks: a row tile is split along W only where that shortens the
    chunks.  No chunk is empty."""
    segs = -(-wd // SEGMENT)
    row_tiles = b * -(-h // th)
    want = max(1, min(resident // (3 * -(-cin // 64) * -(-cout // 64)), 65535))
    best = None
    for pieces in range(1, min(segs, want) + 1):
        per = -(-segs // pieces)
        if -(-segs // per) != pieces:
            continue  # the same split as fewer pieces
        tiles = -(-row_tiles // (want // pieces))
        chunks = -(-row_tiles // tiles) * pieces
        key = (tiles * min(th, h) * per, chunks)
        if best is None or key < best[0]:
            best = key, (chunks, tiles, per)
    return best[1]


def chunk_extents(b: int, h: int, wd: int, th: int, tiles: int, segs: int):
    """Each chunk's pixels as the kernels' blocks walk them, chunk by chunk:
    (first image row of the B * H, one past its last; first row segment,
    one past its last)."""
    sample_tiles = -(-h // th)
    row_tiles = b * sample_tiles
    nseg = -(-wd // SEGMENT)
    pieces = -(-nseg // segs)

    def row(rt):
        return rt // sample_tiles * h + rt % sample_tiles * th

    out = []
    for c in range(-(-row_tiles // tiles) * pieces):
        rt0, s0 = c // pieces * tiles, c % pieces * segs
        out.append((row(rt0), row(min(rt0 + tiles, row_tiles)), s0, min(s0 + segs, nseg)))
    return out


def launch_plan(b: int, h: int, wd: int, cin: int, cout: int, th: int, resident: int):
    """The f32 scratch a call allocates, (partials, 9 * Cin * Cout), one
    partial a chunk of ``xcol_gtcol_plan``, and the arguments its C entry
    takes after th: (row tiles, segments) a chunk."""
    chunks, tiles, segs = xcol_gtcol_plan(b, h, wd, cin, cout, th, resident)
    return (chunks, 9 * cin * cout), (tiles, segs)


def _resident(name: str, x: torch.Tensor) -> int:
    """Blocks of variant ``name``'s kernel that x's card holds at once,
    asked once."""
    key = (x.device.index, name)
    if key not in _resident_blocks:
        with torch.cuda.device(x.device):
            cap = getattr(_kernels.library("wgrad_variants"),
                          f"{PREFIX[name]}_resident_blocks")()
        if cap <= 0:
            raise RuntimeError(f"wgrad_{name}: occupancy query failed")
        _resident_blocks[key] = cap
    return _resident_blocks[key]


def _launch(name: str, plain, x: torch.Tensor, g: torch.Tensor, th: int):
    if x.device.type == "cpu":
        return plain(x, g, th)
    what = f"wgrad_{name}"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"{what}: {x.dtype} and {g.dtype} (the kernel takes bfloat16)")
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and g {tuple(g.shape)}")
    if g.device != x.device or not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous on one device")
    if not isinstance(th, int) or th < 1:
        raise ValueError(f"{what}: th must be a positive int, got {th!r}")
    b, h, wd, cin = x.shape
    cout = g.shape[-1]
    if max(cin, cout) > MAX_CHANNELS:
        raise ValueError(f"{what}: at most {MAX_CHANNELS} channels, got {cin} -> {cout}")
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    if x.numel() == 0:
        return dw.zero_()
    shape, plan = launch_plan(b, h, wd, cin, cout, th, _resident(name, x))
    part = torch.empty(shape, dtype=torch.float32, device=x.device)
    entry = f"{PREFIX[name]}_{what}"
    _kernels.launch("wgrad_variants", entry, f"{what} ({entry})", x.get_device(), x.data_ptr(),
                    g.data_ptr(), part.data_ptr(), dw.data_ptr(), b, h, wd, cin, cout, th, *plan)
    globals()[f"{name}_launches"] += 1
    return dw


def wgrad_gcol(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T1: (3, 3, Cin, Cout) f32 from x (B, H, W, Cin) and g (B, H, W, Cout)."""
    return _launch("gcol", wgrad_gcol_plain, x, g, th)


def wgrad_xcol(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T2: (3, 3, Cin, Cout) f32 from x (B, H, W, Cin) and g (B, H, W, Cout)."""
    return _launch("xcol", wgrad_xcol_plain, x, g, th)


def wgrad_gt9(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T3: (3, 3, Cin, Cout) f32 from x (B, H, W, Cin) and g (B, H, W, Cout)."""
    return _launch("gt9", wgrad_gt9_plain, x, g, th)


def wgrad_gtcol(x: torch.Tensor, g: torch.Tensor, th: int) -> torch.Tensor:
    """T4: (3, 3, Cin, Cout) f32 from x (B, H, W, Cin) and g (B, H, W, Cout)."""
    return _launch("gtcol", wgrad_gtcol_plain, x, g, th)


VARIANTS = {  # name -> (wrapper, plain version)
    "gcol": (wgrad_gcol, wgrad_gcol_plain),
    "xcol": (wgrad_xcol, wgrad_xcol_plain),
    "gt9": (wgrad_gt9, wgrad_gt9_plain),
    "gtcol": (wgrad_gtcol, wgrad_gtcol_plain),
}
