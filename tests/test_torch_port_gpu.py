"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided in the
fixture).  On the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q

Shapes are small but ragged (tiles cut, runs crossing tile edges, whole-
sample runs, objects past the map's edge).  K1's cases are cut at its own
tile size (``k1_tile_rows``): runs of T - 1, T, T + 1 and 2T + 1 rows, a
whole-sample run, fewer rows than a tile, 8, 11, 32 and 64 channels and
vals off a 16-byte boundary (its 16-byte and element loads), an all -inf
run, and the fused max backward on tied maxima.  K4 runs ragged words, K =
1024 with every candidate kept or all suppressed by the first, both sides
of its shared-memory layout's limit (1,344) and up to the 4,096 it takes;
K3 windows across its tile edges (its tile read from the library), 500
slots on one center, negative and positive gauss fills and the callers' own
dtypes.  Max, keep masks, last-wins stamps and launch counts
are exact; gaussian stamps within 2e-6 (analytic
exp against the f64-built table); f32 sums and convs are held to f32
rounding, bf16 ones to one or two bf16 roundings.  The backward passes (K1
max and sum, K2 dgrad, K2w) are held against the plain versions' autograd.
The wgrad formulations T1-T4 are held to 1e-5 * sum |x||g| (bf16 products
are exact in f32), also at the edges of T2's and T4's tiles and chunks.  The tensor-core K2 (forward and dgrad) and K2w get
cases that reach their tiles' edges: Cout 256, W no multiple of 64, H = 1,
ragged channels and x off a 16-byte boundary.
"""
import math

import numpy as np
import pytest
import torch

from com_tpu_torch.ops import _kernels, conv2d, nms, seg_scan, stamp, wgrad_variants

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("b,n,nseg,c", [(2, 300, 10, 8), (1, 5000, 1, 32),
                                        (3, 3 * 1024 + 5, 40, 11), (2, 4100, 4000, 64)])
def test_run_bcast_kernel(dev, dtype, op, b, n, nseg, c):
    rng = np.random.RandomState(b * 1000 + n + c)
    seg = torch.from_numpy(np.sort(rng.randint(0, nseg, (b, n)), axis=1).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev).to(dtype)
    before = seg_scan.launches
    got = seg_scan.run_bcast(vals, seg, op)
    torch.cuda.synchronize()
    assert seg_scan.launches == before + 1 and got.dtype == dtype
    want = seg_scan.run_bcast_plain(vals, seg, op)
    if op == "max":
        assert torch.equal(got, want)
    else:
        scale = seg_scan.run_bcast_plain(vals.float().abs(), seg, "sum")
        rnd = 0.0 if dtype == torch.float32 else 2.0 ** -8
        err = (got.float() - want.float()).abs()
        assert bool((err <= 1e-5 * scale + rnd * want.float().abs() + 1e-6).all())


def _k1_case(dev, rng, op, dtype, c, layout, offset):
    """Ids and values at K1's own tile size for (c, dtype, op): sample 0 with
    runs of T - 1, T, T + 1 and 2T + 1 rows between short ones (so they
    straddle tile edges), or fewer rows than one tile; sample 1 one run over
    the whole sample.  vals starts `offset` elements past an allocation."""
    lib = _kernels.library("seg_scan")
    t = lib.k1_tile_rows(c, int(dtype == torch.bfloat16), {"sum": 0, "max": 1, "bwd": 2}[op])
    if layout == "edges":
        lengths = []
        for length in (t - 1, t, t + 1, 2 * t + 1):
            lengths += list(rng.randint(1, 6, rng.randint(1, 8))) + [length]
        lengths += list(rng.randint(1, 6, 20))
    else:
        lengths = list(rng.randint(1, 6, t // 8))
    ids = np.repeat(np.arange(len(lengths)), lengths)
    ids = ids[:t // 3] if layout == "short" else ids
    n = len(ids)
    seg = torch.from_numpy(np.stack([ids, np.full(n, 3)]).astype(np.int32)).to(dev)
    vals = rng.randn(2, n, c).astype(np.float32)
    if op == "bwd":
        vals = np.round(vals * 2) / 2  # coarse values: tied maxima
    flat = torch.zeros(2 * n * c + offset, device=dev, dtype=dtype)
    flat[offset:] = torch.from_numpy(vals.reshape(-1)).to(dev).to(dtype)
    return seg, flat[offset:].view(2, n, c), ids


@pytest.mark.parametrize("offset", [0, 1])  # 1: vals off a 16-byte boundary, element loads
@pytest.mark.parametrize("layout", ["edges", "short"])
@pytest.mark.parametrize("c", [8, 11, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_bcast_kernel_tile_edges(dev, op, dtype, c, layout, offset):
    rng = np.random.RandomState(c * 10 + offset + (layout == "short") * 100)
    seg, vals, ids = _k1_case(dev, rng, op, dtype, c, layout, offset)
    if op == "max":  # a run all -inf: its max is non-finite and becomes 0
        vals[0, torch.from_numpy(ids == 1).to(dev)] = -math.inf
    before = seg_scan.launches
    got = seg_scan.run_bcast(vals, seg, op)
    torch.cuda.synchronize()
    assert seg_scan.launches == before + 1 and got.dtype == dtype
    want = seg_scan.run_bcast_plain(vals, seg, op)
    if op == "max":
        assert torch.equal(got, want)
        assert bool((got[0, torch.from_numpy(ids == 1).to(dev)] == 0).all())
    else:
        scale = seg_scan.run_bcast_plain(vals.float().abs(), seg, "sum")
        rnd = 0.0 if dtype == torch.float32 else 2.0 ** -8
        err = (got.float() - want.float()).abs()
        assert bool((err <= 1e-5 * scale + rnd * want.float().abs() + 1e-6).all())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("layout", ["edges", "short"])
@pytest.mark.parametrize("c", [8, 11, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_run_bcast_max_backward_fused_kernel(dev, dtype, c, layout, offset):
    """The fused max backward (one launch) on tied maxima, runs across tile
    edges and a whole-sample run: through autograd against
    run_bcast_plain's autograd, and called directly against its plain
    version."""
    rng = np.random.RandomState(c * 10 + offset + (layout == "short") * 100 + 7)
    seg, vals, _ = _k1_case(dev, rng, "bwd", dtype, c, layout, offset)
    gy = torch.from_numpy(rng.randn(*vals.shape).astype(np.float32)).to(dev).to(dtype)
    grads = []
    for fn in (seg_scan.run_bcast, seg_scan.run_bcast_plain):
        v = vals.clone().requires_grad_()
        before = seg_scan.bwd_launches
        fn(v, seg, "max").backward(gy)
        torch.cuda.synchronize()
        if fn is seg_scan.run_bcast:
            assert seg_scan.bwd_launches == before + 1
        grads.append(v.grad.float())
    got, want = grads
    scale = seg_scan.run_bcast_plain(gy.float().abs(), seg, "sum")
    rnd = 0.0 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got - want).abs() <= 1e-5 * scale + rnd * want.abs() + 1e-6).all())
    out = seg_scan.run_bcast_plain(vals, seg, "max")
    got = seg_scan.run_bcast_max_bwd(gy, vals, out, seg).float()
    want = seg_scan.run_bcast_max_bwd_plain(gy, vals, out, seg).float()
    assert bool(((got - want).abs() <= 1e-5 * scale + rnd * want.abs() + 1e-6).all())
    ties = seg_scan.run_bcast_plain((vals == out).float(), seg, "sum")
    assert bool(((ties > 1) & (vals == out)).any())  # the case holds tied maxima


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 23, 37, 8, 16), (1, 17, 117, 64, 72),
                                            (1, 9, 9, 13, 3)])
def test_conv3x3_kernel(dev, dtype, b, h, w, cin, cout):
    g = torch.Generator(device=dev).manual_seed(h * w + cin)
    x = torch.randn((b, h, w, cin), device=dev, generator=g).to(dtype)
    wt = (torch.randn((3, 3, cin, cout), device=dev, generator=g) / (3 * cin ** 0.5)).to(dtype)
    before = conv2d.launches
    got = conv2d.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert conv2d.launches == before + 1 and got.dtype == dtype
    want = conv2d.conv3x3_plain(x, wt)
    absref = conv2d.conv3x3_plain(x.float().abs(), wt.float().abs())
    rnd = 0.0 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-5 * absref + rnd * want.float().abs()).all())


@pytest.mark.parametrize("k", [1, 64, 65, 129, 500, 700, 1344])
def test_greedy_suppress_kernel(dev, k):
    rng = np.random.RandomState(k)
    over = torch.from_numpy(rng.rand(2, k, k) < 0.02).to(dev)
    valid = torch.from_numpy(rng.rand(2, k) < 0.9).to(dev)
    before = nms.launches
    got = nms.greedy_suppress(over, valid)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(got, nms.greedy_suppress_plain(over, valid))


@pytest.mark.parametrize("case", ["none_suppressed", "first_suppresses_all", "sparse"])
@pytest.mark.parametrize("k", [500, 1024])
def test_greedy_suppress_kernel_extremes(dev, case, k):
    """Every candidate valid: each kept (its own row only), all suppressed by
    the first, or NMS-like sparse overlap (chains of hundreds kept); one
    candidate past the most K4 takes raises."""
    over = torch.eye(k, dtype=torch.bool, device=dev).repeat(2, 1, 1)
    if case == "first_suppresses_all":
        over[:, 0] = True
    elif case == "sparse":
        gen = torch.Generator(device=dev).manual_seed(k)
        over |= torch.rand((2, k, k), device=dev, generator=gen) < 2.0 / k
    valid = torch.ones((2, k), dtype=torch.bool, device=dev)
    got = nms.greedy_suppress(over, valid)
    assert torch.equal(got, nms.greedy_suppress_plain(over, valid))
    kept = {"none_suppressed": k, "first_suppresses_all": 1}.get(case)
    assert kept is None or got.sum(1).tolist() == [kept] * 2
    k_over = nms.max_candidates() + 1
    with pytest.raises(ValueError, match="K4 takes at most"):
        nms.greedy_suppress(torch.zeros((1, k_over, k_over), dtype=torch.bool, device=dev),
                            torch.ones((1, k_over), dtype=torch.bool, device=dev))


@pytest.mark.parametrize("case", ["sparse", "none_suppressed", "first_suppresses_all"])
@pytest.mark.parametrize("b,k", [(2, 500), (2, 1344), (2, 1345), (4, 4095), (4, 4096)])
def test_greedy_suppress_kernel_either_layout(dev, case, b, k):
    """K4 bitwise against greedy_suppress_plain on both sides of the
    shared-memory layout's limit (1,344) and up to the most it takes: 4,096
    at the anchor configs' batch of 4, and 4,095 (no multiple of 64).  Each
    sample sparse and NMS-like, with invalid candidates; or every candidate
    valid, each kept or all suppressed by the first."""
    assert nms.max_candidates() >= 4096
    gen = torch.Generator(device=dev).manual_seed(b * k)
    over = torch.eye(k, dtype=torch.bool, device=dev).repeat(b, 1, 1)
    valid = torch.ones((b, k), dtype=torch.bool, device=dev)
    if case == "sparse":
        over |= torch.rand((b, k, k), device=dev, generator=gen) < 4.0 / k
        valid = torch.rand((b, k), device=dev, generator=gen) < 0.9
    elif case == "first_suppresses_all":
        over[:, 0] = True
    before = nms.launches
    got = nms.greedy_suppress(over, valid)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(got, nms.greedy_suppress_plain(over, valid))
    kept = {"none_suppressed": k, "first_suppresses_all": 1}.get(case)
    assert kept is None or got.sum(1).tolist() == [kept] * b


def _stamp_check(got, want, mode, args, c, h, w, max_radius=16):
    """Gauss within 2e-6 of the plain version with every valid center
    exactly 1.0 (for a fill of at most 1); last_wins exact."""
    if mode == "last_wins":
        assert torch.equal(got, want)
        return
    assert float((got - want).abs().max()) <= 2e-6
    cx, cy, rr, cl = stamp._preprocess(args[0], args[1], args[2], args[4], c, h, w, max_radius)
    bi, oi = torch.nonzero(rr >= 0, as_tuple=True)
    assert bool((got[bi, cl[bi, oi].long(), cy[bi, oi].long(), cx[bi, oi].long()] == 1.0).all())


@pytest.mark.parametrize("mode", ["gauss", "last_wins"])
@pytest.mark.parametrize("b,n,c,h,w", [(2, 40, 3, 70, 52), (1, 500, 3, 117, 90), (2, 1, 1, 5, 7)])
def test_stamp_kernel(dev, mode, b, n, c, h, w):
    rng = np.random.RandomState(b * 100 + n + h)
    centers = np.stack([rng.randint(-3, w + 3, (b, n)), rng.randint(-3, h + 3, (b, n))], -1)
    radii = rng.randint(-1, 20, (b, n))
    cls = rng.randint(0, c + 1, (b, n))
    values = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    valid = rng.rand(b, n) > 0.3
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (centers.astype(np.int32), radii.astype(np.int32), cls.astype(np.int32), values, valid)]
    fill = 0.0 if mode == "gauss" else 1.0
    before = (stamp.gauss_launches, stamp.last_wins_launches)
    got = stamp.stamp_windows(*args, c, h, w, mode, fill=fill)
    torch.cuda.synchronize()
    after = (stamp.gauss_launches, stamp.last_wins_launches)
    assert after[mode == "last_wins"] == before[mode == "last_wins"] + 1
    want = stamp.stamp_windows_plain(*args, c, h, w, mode, fill=fill)
    if mode == "gauss":
        assert float((got - want).abs().max()) <= 2e-6
        cx, cy, rr, cl = stamp._preprocess(args[0], args[1], args[2], args[4], c, h, w, 16)
        bi, oi = torch.nonzero(rr >= 0, as_tuple=True)
        assert bool((got[bi, cl[bi, oi].long(), cy[bi, oi].long(), cx[bi, oi].long()] == 1.0).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["gauss", "last_wins"])
@pytest.mark.parametrize("w", [300, 301])  # 301: no 16-byte stores
def test_stamp_kernel_tile_edges(dev, mode, w):
    """Windows on both sides of the kernel's tile edges (the tile read from
    the library), and crossing them by every radius up to the clip; 1200
    slots, more than one chunk of the kernel's object list."""
    lib = _kernels.library("stamp")
    th, tw = lib.k3_tile(0), lib.k3_tile(1)
    rng = np.random.RandomState(th * 1000 + tw + w)
    b, n, c, h = 2, 1200, 2, 3 * th + 5
    xs = np.concatenate([np.arange(tw, w, tw)[:, None] + np.array([[-1, 0, 1]])]).ravel()
    ys = np.concatenate([np.arange(th, h, th)[:, None] + np.array([[-1, 0, 1]])]).ravel()
    centers = np.stack([rng.choice(xs, (b, n)), rng.choice(ys, (b, n))], -1)
    centers[:, ::3, 0] = rng.randint(0, w, (b, (n + 2) // 3))
    radii = rng.randint(0, 17, (b, n))
    cls = rng.randint(0, c, (b, n))
    values = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    valid = rng.rand(b, n) > 0.5
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
            (centers.astype(np.int32), radii.astype(np.int32), cls.astype(np.int32), values, valid)]
    fill = 0.0 if mode == "gauss" else 1.0
    got = stamp.stamp_windows(*args, c, h, w, mode, fill=fill)
    want = stamp.stamp_windows_plain(*args, c, h, w, mode, fill=fill)
    _stamp_check(got, want, mode, args, c, h, w)


def test_stamp_kernel_last_wins_ties_by_index(dev):
    """500 valid slots of radius 16 on one center: every cell of the window
    takes the value of the last slot, and the gaussian its one window."""
    b, n, c, h, w = 2, 500, 3, 60, 70
    centers = torch.tensor([30, 25], dtype=torch.int32, device=dev).repeat(b, n, 1)
    radii = torch.full((b, n), 16, dtype=torch.int32, device=dev)
    cls = torch.ones((b, n), dtype=torch.int32, device=dev)
    values = torch.arange(b * n, dtype=torch.float32, device=dev).reshape(b, n) + 1
    valid = torch.ones((b, n), dtype=torch.bool, device=dev)
    args = (centers, radii, cls, values, valid)
    got = stamp.stamp_windows(*args, c, h, w, "last_wins", fill=-1.0)
    assert torch.equal(got, stamp.stamp_windows_plain(*args, c, h, w, "last_wins", fill=-1.0))
    assert bool((got[:, 1, 9:42, 14:47] == values[:, -1, None, None]).all())
    assert int((got != -1.0).sum()) == b * 33 * 33
    gauss = stamp.stamp_windows(*args, c, h, w, "gauss")
    _stamp_check(gauss, stamp.stamp_windows_plain(*args, c, h, w, "gauss"), "gauss", args, c, h,
                 w)


@pytest.mark.parametrize("fill", [-0.5, 0.25])
def test_stamp_kernel_gauss_fill(dev, fill):
    """Gauss over a negative fill (every stamped value above it) and over a
    positive one (the window's tails below it keep the fill)."""
    rng = np.random.RandomState(7 if fill < 0 else 8)
    b, n, c, h, w = 2, 60, 3, 50, 64
    args = [torch.from_numpy(a).to(dev) for a in (
        np.stack([rng.randint(0, w, (b, n)), rng.randint(0, h, (b, n))], -1).astype(np.int32),
        rng.randint(0, 17, (b, n)).astype(np.int32), rng.randint(0, c, (b, n)).astype(np.int32),
        rng.uniform(0.5, 1.5, (b, n)).astype(np.float32), rng.rand(b, n) > 0.3)]
    got = stamp.stamp_windows(*args, c, h, w, "gauss", fill=fill)
    want = stamp.stamp_windows_plain(*args, c, h, w, "gauss", fill=fill)
    _stamp_check(got, want, "gauss", args, c, h, w)
    assert float(got.min()) == fill


def test_stamp_kernel_takes_the_callers_dtypes(dev):
    """The two callers' own tensors, launched as they are: the heatmap
    targets (int32 ids, no values, gauss) and the COM loss mask (int32
    centers and radii, int64 classes, f32 weights, last_wins); one launch
    each, against the plain version."""
    from com_tpu_torch.ops import gaussian

    rng = np.random.RandomState(21)
    b, n, c, h, w = 2, 500, 3, 117, 117
    centers = torch.from_numpy(np.stack([rng.randint(0, w, (b, n)), rng.randint(0, h, (b, n))],
                                        -1).astype(np.int32)).to(dev)
    radii = torch.from_numpy(rng.randint(2, 20, (b, n)).astype(np.int32)).to(dev)
    cls = torch.from_numpy(rng.randint(0, c, (b, n)).astype(np.int32)).to(dev)
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(b, n) < 0.2).to(dev)
    before = (stamp.gauss_launches, stamp.last_wins_launches)
    hm = gaussian.draw_gaussians_batched(centers, radii, cls, valid, c, h, w)
    mask = gaussian.stamp_squares_batched(centers, radii, cls.long(), weight, valid, c, h, w,
                                          fill=1.0)
    assert (stamp.gauss_launches, stamp.last_wins_launches) == (before[0] + 1, before[1] + 1)
    args = (centers, radii, cls, weight, valid)
    _stamp_check(hm, stamp.stamp_windows_plain(*args, c, h, w, "gauss"), "gauss", args, c, h, w)
    assert torch.equal(mask, stamp.stamp_windows_plain(*args, c, h, w, "last_wins", fill=1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout,offset", [
    (2, 23, 37, 8, 16, 0), (1, 17, 117, 64, 72, 0), (1, 9, 9, 13, 3, 0), (2, 30, 30, 130, 70, 0),
    (2, 19, 41, 64, 64, 1)])  # x off a 16-byte boundary takes the element-wise loads
def test_conv3x3_wgrad_kernel(dev, dtype, b, h, w, cin, cout, offset):
    g = torch.Generator(device=dev).manual_seed(h * w + cin + cout)
    shape = (b, h, w, cin)
    x = torch.randn(math.prod(shape) + offset, device=dev, generator=g).to(dtype)[offset:]
    x = x.view(shape)
    gy = torch.randn((b, h, w, cout), device=dev, generator=g).to(dtype)
    before = conv2d.wgrad_launches
    got = conv2d.conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert conv2d.wgrad_launches == before + 1 and got.dtype == torch.float32
    want = conv2d.conv3x3_wgrad_plain(x, gy)
    absref = conv2d.conv3x3_wgrad_plain(x.float().abs(), gy.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * absref + 1e-6).all())
    assert torch.equal(got, conv2d.conv3x3_wgrad(x, gy))  # no atomics: the same every run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_backward_kernels(dev, dtype):
    """dgrad (K2 on the rotated kernel) and wgrad (K2w) through the
    autograd.Function, against conv3x3_plain's autograd."""
    g = torch.Generator(device=dev).manual_seed(11)
    x0 = torch.randn((2, 21, 34, 16), device=dev, generator=g).to(dtype)
    w0 = (torch.randn((3, 3, 16, 24), device=dev, generator=g) / 12).to(dtype)
    gy = torch.randn((2, 21, 34, 24), device=dev, generator=g).to(dtype)
    grads = []
    for fn in (conv2d.conv3x3, conv2d.conv3x3_plain):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        before = (conv2d.dgrad_launches, conv2d.wgrad_launches)
        fn(x, w).backward(gy)
        torch.cuda.synchronize()
        if fn is conv2d.conv3x3:
            assert (conv2d.dgrad_launches, conv2d.wgrad_launches) == (before[0] + 1, before[1] + 1)
        grads.append((x.grad, w.grad))
    (dx, dw), (pdx, pdw) = grads
    assert dx.dtype == dtype and dw.dtype == dtype
    rnd = 0.0 if dtype == torch.float32 else 2.0 ** -7
    w_rot = w0.float().flip(0).flip(1).transpose(2, 3)
    absdx = conv2d.conv3x3_plain(gy.float().abs(), w_rot.abs())
    absdw = conv2d.conv3x3_wgrad_plain(x0.float().abs(), gy.float().abs())
    assert bool(((dx.float() - pdx.float()).abs() <= 1e-5 * absdx + rnd * pdx.float().abs()).all())
    assert bool(((dw.float() - pdw.float()).abs() <= 1e-5 * absdw + rnd * pdw.float().abs()).all())


# the bf16 K2 and K2w tiles: Cout 256, W no multiple of 64, H = 1, ragged
# channels, x off a 16-byte boundary (the element-wise loads)
BF16_TILE_CASES = [(1, 5, 70, 256, 256, 0), (2, 1, 130, 64, 64, 0), (1, 7, 117, 8, 16, 0),
                   (1, 9, 65, 64, 72, 0), (2, 6, 40, 64, 64, 1), (1, 3, 3, 13, 3, 0)]


def _offset_randn(dev, gen, shape, offset, scale=1.0):
    """A contiguous bf16 tensor whose data starts ``offset`` elements into
    its storage."""
    flat = (torch.randn(math.prod(shape) + offset, device=dev, generator=gen) * scale)
    return flat.to(torch.bfloat16)[offset:].view(shape)


@pytest.mark.parametrize("b,h,w,cin,cout,offset", BF16_TILE_CASES)
def test_conv3x3_bf16_tiles_forward_and_dgrad(dev, b, h, w, cin, cout, offset):
    """The tensor-core K2, forward and dgrad through autograd, against
    conv3x3_plain's autograd; one launch each."""
    gen = torch.Generator(device=dev).manual_seed(h * w + cin + cout + offset)
    x0 = _offset_randn(dev, gen, (b, h, w, cin), offset)
    wt = (torch.randn((3, 3, cin, cout), device=dev, generator=gen) / (3 * cin ** 0.5))
    wt = wt.to(torch.bfloat16)
    gy = torch.randn((b, h, w, cout), device=dev, generator=gen).to(torch.bfloat16)
    runs = []
    for fn in (conv2d.conv3x3, conv2d.conv3x3_plain):
        x = x0.detach().requires_grad_()
        before = (conv2d.launches, conv2d.dgrad_launches)
        y = fn(x, wt)
        dx, = torch.autograd.grad(y, x, gy)
        torch.cuda.synchronize()
        if fn is conv2d.conv3x3:
            assert (conv2d.launches, conv2d.dgrad_launches) == (before[0] + 1, before[1] + 1)
        runs.append((y.float(), dx.float()))
    (y, dx), (py, pdx) = runs
    rnd = 2.0 ** -7
    absy = conv2d.conv3x3_plain(x0.float().abs(), wt.float().abs())
    assert bool(((y - py).abs() <= 1e-5 * absy + rnd * py.abs()).all())
    absdx = conv2d.conv3x3_plain(gy.float().abs(), conv2d.rotate_kernel(wt.float().abs()))
    assert bool(((dx - pdx).abs() <= 1e-5 * absdx + rnd * pdx.abs()).all())


@pytest.mark.parametrize("b,h,w,cin,cout,offset", BF16_TILE_CASES + [(1, 4, 200, 128, 128, 0)])
def test_conv3x3_wgrad_bf16_tiles(dev, b, h, w, cin, cout, offset):
    gen = torch.Generator(device=dev).manual_seed(h * w + cin + cout + offset)
    x = _offset_randn(dev, gen, (b, h, w, cin), offset)
    gy = torch.randn((b, h, w, cout), device=dev, generator=gen).to(torch.bfloat16)
    before = conv2d.wgrad_launches
    got = conv2d.conv3x3_wgrad(x, gy)
    torch.cuda.synchronize()
    assert conv2d.wgrad_launches == before + 1 and got.shape == (3, 3, cin, cout)
    want = conv2d.conv3x3_wgrad_plain(x, gy)
    absref = conv2d.conv3x3_wgrad_plain(x.float().abs(), gy.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * absref + 1e-6).all())
    assert torch.equal(got, conv2d.conv3x3_wgrad(x, gy))  # no atomics: the same every run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_bcast_backward_kernel(dev, dtype, op):
    rng = np.random.RandomState(7)
    b, n, c = 2, 3 * 1024 + 5, 32
    seg = torch.from_numpy(np.sort(rng.randint(0, 300, (b, n)), axis=1).astype(np.int32)).to(dev)
    vals = torch.from_numpy((np.round(rng.randn(b, n, c) * 2) / 2).astype(np.float32))
    vals = vals.to(dev).to(dtype)
    gy = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev).to(dtype)
    grads = []
    for fn in (seg_scan.run_bcast, seg_scan.run_bcast_plain):
        v = vals.clone().requires_grad_()
        before = seg_scan.bwd_launches
        fn(v, seg, op).backward(gy)
        torch.cuda.synchronize()
        if fn is seg_scan.run_bcast:
            assert seg_scan.bwd_launches == before + 1  # one K1 sum, or the fused max backward
        grads.append(v.grad.float())
    got, want = grads
    scale = seg_scan.run_bcast_plain(gy.float().abs(), seg, "sum")
    rnd = 0.0 if dtype == torch.float32 else 2.0 ** -7  # gsum, then the split, rounded
    assert bool(((got - want).abs() <= 1e-5 * scale + rnd * want.abs() + 1e-6).all())


@pytest.mark.parametrize("th", [8, 16])
@pytest.mark.parametrize("b,h,w,cin,cout,offset", [
    (2, 21, 37, 13, 24, 0), (1, 19, 65, 40, 8, 0), (2, 9, 131, 64, 72, 0), (1, 35, 23, 136, 16, 0),
    (2, 17, 29, 16, 32, 1),  # x off a 16-byte boundary takes the element-wise loads
    # T2's and T4's tiles and chunks: Cin at the limit and three 64-channel
    # slices, W a multiple of 64 and one past it, H = 1 and th past H, and
    # the sweep's shapes cut to 24 rows
    (1, 6, 40, 256, 16, 0), (1, 5, 50, 192, 72, 0), (2, 7, 128, 64, 64, 0), (1, 9, 65, 32, 64, 0),
    (2, 1, 100, 64, 32, 0), (2, 24, 468, 64, 64, 0), (2, 24, 468, 128, 64, 0),
    # channel counts no multiple of 8 (the element loads) on both operands,
    # and last row segments 1-2 pixels wide, whose dx = 2 view (T3) or
    # column block (T1: dx = 0) reads the halo row's last pixel
    (1, 11, 70, 20, 36, 0), (2, 6, 66, 12, 72, 0), (1, 5, 130, 72, 40, 0),
    (2, 4, 129, 100, 9, 0)])
@pytest.mark.parametrize("variant", ["gcol", "xcol", "gt9", "gtcol"])
def test_wgrad_variant_kernel(dev, variant, b, h, w, cin, cout, offset, th):
    g = torch.Generator(device=dev).manual_seed(h * w + cin + cout)
    shape = (b, h, w, cin)
    x = (torch.randn(math.prod(shape) + offset, device=dev, generator=g) * 0.3)
    x = x.to(torch.bfloat16)[offset:].view(shape)
    gy = (torch.randn((b, h, w, cout), device=dev, generator=g) * 0.3).to(torch.bfloat16)
    fn, plain = wgrad_variants.VARIANTS[variant]
    counter = f"{variant}_launches"
    before = getattr(wgrad_variants, counter)
    got = fn(x, gy, th)
    torch.cuda.synchronize()
    assert getattr(wgrad_variants, counter) == before + 1
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    want = plain(x, gy, th)
    absref = wgrad_variants.oracle(x.float().abs(), gy.float().abs())
    assert bool(((got - want).abs() <= 1e-5 * absref).all())
    assert torch.equal(got, fn(x, gy, th))  # no atomics: the same every run
    with pytest.raises(TypeError):
        fn(x.float(), gy.float(), th)
    assert getattr(wgrad_variants, counter) == before + 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((1, 4, 4, 2), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv2d.conv3x3(x, torch.zeros((3, 3, 2, 2), device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        conv2d.conv3x3(x.float().transpose(1, 2), torch.zeros((3, 3, 2, 2), device=dev))
    with pytest.raises(TypeError):
        seg_scan.run_bcast(torch.zeros((1, 4, 2), device=dev),
                           torch.zeros((1, 4), device=dev, dtype=torch.int64))
    with pytest.raises(TypeError):
        seg_scan.run_bcast_max_bwd(torch.zeros((1, 4, 2), device=dev, dtype=torch.bfloat16),
                                   torch.zeros((1, 4, 2), device=dev),
                                   torch.zeros((1, 4, 2), device=dev),
                                   torch.zeros((1, 4), device=dev, dtype=torch.int32))
    with pytest.raises(TypeError):
        nms.greedy_suppress(torch.zeros((1, 3, 3), device=dev), torch.ones((1, 3), device=dev,
                                                                          dtype=torch.bool))
    with pytest.raises(TypeError):
        conv2d.conv3x3_wgrad(x, torch.zeros((1, 4, 4, 2), device=dev, dtype=torch.float16))
    for fn, _ in wgrad_variants.VARIANTS.values():
        with pytest.raises(ValueError):  # more channels than the halo rows hold
            fn(torch.zeros((1, 4, 4, 264), device=dev, dtype=torch.bfloat16),
               torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.bfloat16), 8)
        with pytest.raises(ValueError):
            fn(torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.bfloat16).transpose(1, 2),
               torch.zeros((1, 4, 4, 8), device=dev, dtype=torch.bfloat16), 8)
    with pytest.raises(TypeError):
        stamp.stamp_windows(torch.zeros((1, 2, 2), device=dev), torch.zeros((1, 2), device=dev),
                            torch.zeros((1, 2), device=dev), torch.zeros((1, 2), device=dev),
                            torch.ones((1, 2), device=dev, dtype=torch.bool), 1, 4, 4, "gauss")
    ids = torch.zeros((1, 2), device=dev, dtype=torch.int32)
    for radii, values in ((ids.short(), ids.float()), (ids, ids.double())):  # no conversion
        with pytest.raises(TypeError):
            stamp.stamp_windows(torch.zeros((1, 2, 2), device=dev, dtype=torch.int32), radii, ids,
                                values, torch.ones((1, 2), device=dev, dtype=torch.bool), 1, 4,
                                4, "last_wins")


def test_serving_step_matches_cpu(dev):
    """The eval step on a 32x32 grid in f32: card (kernels) vs CPU (plain
    versions), same weights."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    meta = DatasetMeta(cfg.CLASS_NAMES, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0),
                       (0.32, 0.32, 6.0), (32, 32, 1), 5)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (2, 2048))
    batch = {"points": pts, "points_mask": np.ones((2, 2048), bool)}
    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


def test_train_step_matches_cpu(dev):
    """One train step at a 32x32 grid in f32 from the same weights: card
    (kernels) against CPU (plain versions): loss, every gradient, the
    batch-norm statistics and the confidence accumulators.  The running
    statistics start at 0, so after one forward they are (1 - 0.99) times
    the batch statistics, which are compared per channel against the
    second moment E[x^2] that both are summed from."""
    _train_step_card_against_cpu(dev, bias_shift=0.0)


def test_train_step_matches_cpu_biases_moved(dev):
    """The same step with every norm's bias moved up by 3 first, as in the
    CPU slice tests and chip_smoke's small train reference: with almost no
    ReLU input near the kink, the comparison does not hang on rounding.
    With the biases at 0 (above), the outcome on the card turns on the
    rounding of K1's f32 sums and of the library's kernels
    (``com_tpu_torch.tools.perf.k1_path parity``, PERF.md)."""
    _train_step_card_against_cpu(dev, bias_shift=3.0)


def _train_step_card_against_cpu(dev, bias_shift):
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = True
    meta = DatasetMeta(cfg.CLASS_NAMES, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0),
                       (0.32, 0.32, 6.0), (32, 32, 1), 5)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (2, 2048))
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-4, 4, (2, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 3.0, (2, 6, 3))
    gt[:, :6, 7] = rng.randint(1, 4, (2, 6))
    batch = {"points": pts, "points_mask": np.ones((2, 2048), bool), "gt_boxes": gt,
             "true_object": (gt[..., 7] > 0).astype(np.float32),
             "occupancy_ratio": rng.rand(2, 16).astype(np.float32),
             "facade_type": rng.randint(0, 4, (2, 16)).astype(np.float32)}
    _step_card_against_cpu(dev, cfg, meta, batch, bias_shift)


def _step_card_against_cpu(dev, cfg, meta, batch, bias_shift):
    """One train step of ``cfg`` on ``batch`` from the same weights (norm
    biases moved by ``bias_shift``), card against CPU."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.models.layers import BatchNorm
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.state import TrainState
    from com_tpu_torch.train.step import conf_shape_for, make_train_step

    names = list(cfg.CLASS_NAMES)
    runs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        with torch.no_grad():
            for mod in net.modules():
                if isinstance(mod, BatchNorm):
                    mod.bias.add_(bias_shift)
        opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
        state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device=d)
        step = make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device=d)
        running = {k: v for k, v in net.state_dict().items() if "running" in k}
        for v in running.values():
            v.zero_()
        loss, _, _, _ = step.loss_fn(state, batch, 0)
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
        stats = {k: v.cpu() / (1 - BatchNorm.MOMENTUM) for k, v in running.items()}
        net.zero_grad()
        state, m = step(state, batch, 0)
        runs.append((float(loss.detach()), grads, stats, state.conf_sum.cpu(),
                     state.conf_cnt.cpu()))
    (l0, g0, s0, cs0, cc0), (l1, g1, s1, cs1, cc1) = runs
    assert abs(l0 - l1) <= 1e-4 * abs(l1)
    # a conv bias before a training-mode norm has a true gradient of 0: what
    # it reads is rounding noise of the whole net, hence the global term
    gmax = max(float(g.abs().max()) for g in g1.values())
    for k in g1:
        tol = 1e-3 * float(g1[k].abs().max()) + 1e-5 * gmax
        assert float((g0[k] - g1[k]).abs().max()) <= tol, k
    for k in s1:
        if k.endswith("running_mean"):
            norm = k.rsplit(".", 1)[0]
            mean, var = s1[k], s1[f"{norm}.running_var"]
            second = (var + mean * mean).clamp_min(1e-12)
            assert float(((s0[k] - mean).abs() / second.sqrt()).max()) <= 1e-5, k
            assert float(((s0[f"{norm}.running_var"] - var).abs() / second).max()) <= 1e-5, k
    assert torch.equal(cc0, cc1)
    assert float((cs0 - cs1).abs().max()) <= 1e-4


def test_loader_batch_sorted_on_card_and_one_train_step(dev):
    """A batch of the port's own pipeline (synthetic scenes, the flagship's
    COM2 GT-paste, world augmentations and pillar presort, collated) through
    ``DevicePrefetcher`` with the model's batch keys: every sample's valid
    points non-decreasing in the card's pillar id (``point_voxel_ids``),
    then one flagship train step (bf16, a 128x128 grid) with the path's
    launch counts: K1 2 + 1 backward, K2 14 + 14 dgrad, K2w 14, K3 1."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.data.processor import pipeline_presorts_points
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.ops.voxelize import point_voxel_ids
    from com_tpu_torch.train.loop import DevicePrefetcher
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.state import TrainState
    from com_tpu_torch.train.step import conf_shape_for, device_batch_keys, make_train_step
    from com_tpu_torch.utils.config import CfgNode, cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    names, vsize, grid = list(cfg.CLASS_NAMES), (0.32, 0.32, 6.0), (128, 128, 1)
    pc_range = (-20.48, -20.48, -2.0, 20.48, 20.48, 4.0)
    d = cfg.DATA_CONFIG
    ds_cfg = CfgNode({"DATASET": "SyntheticDataset", "NUM_SCENES": 2, "NUM_OBJECTS": 12,
                      "NUM_BG_POINTS": 6000, "POINT_CLOUD_RANGE": list(pc_range),
                      "MAX_POINTS_PER_SCENE": 16384, "MAX_GT_OBJECTS": 500,
                      "POINT_FEATURE_ENCODING": d.POINT_FEATURE_ENCODING,
                      "DATA_AUGMENTOR": d.DATA_AUGMENTOR, "DATA_PROCESSOR": d.DATA_PROCESSOR})
    assert pipeline_presorts_points(ds_cfg, vsize)
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    _, loader = build_dataloader(ds_cfg, names, 2, seed=5, workers=1)
    loader.set_epoch(0)
    keys = device_batch_keys(cfg.MODEL)
    batch = next(iter(DevicePrefetcher(iter(loader), dev, keys)))
    assert set(batch) == keys and batch["points"].device.type == dev.type
    ids, _ = point_voxel_ids(batch["points"][..., :3], pc_range, vsize, grid)
    pair = batch["points_mask"][:, 1:] & batch["points_mask"][:, :-1]
    assert bool(((ids[:, 1:] >= ids[:, :-1]) | ~pair).all())
    assert int(batch["points_mask"].sum()) > 1000

    meta = DatasetMeta(names, pc_range, vsize, grid, 5)
    net = build_network(cfg.MODEL, meta, device=dev, seed=3)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 10, 1)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device=dev)
    step = make_train_step(net, cfg.MODEL, names, meta, opt, grid[1::-1], device=dev)
    counters = [(seg_scan, "launches", 2), (seg_scan, "bwd_launches", 1),
                (conv2d, "launches", 14), (conv2d, "dgrad_launches", 14),
                (conv2d, "wgrad_launches", 14), (stamp, "gauss_launches", 1),
                (stamp, "last_wins_launches", 0)]
    before = [getattr(m, a) for m, a, _ in counters]
    state, metrics = step(state, batch, 0)
    torch.cuda.synchronize()
    assert [getattr(m, a) - b for (m, a, _), b in zip(counters, before)] == \
        [n for *_, n in counters]
    assert np.isfinite(float(metrics["loss"])) and float(state.conf_cnt.sum()) > 0


def test_checkpoint_on_card_resumes_bitwise(dev, tmp_path):
    """A train state saved on the card and loaded into a fresh one there
    (``map_location`` the card) holds every tensor bitwise, and the next
    step of both is bitwise the same (deterministic algorithms on: the
    library's scatter-adds then sum in a fixed order)."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.state import TrainState
    from com_tpu_torch.train.step import conf_shape_for, make_train_step
    from com_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    names = list(cfg.CLASS_NAMES)
    meta = DatasetMeta(names, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0), (0.32, 0.32, 6.0),
                       (32, 32, 1), 5)
    rng = np.random.RandomState(1)
    pts = rng.uniform(-5, 5, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (2, 2048))
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-4, 4, (2, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 3.0, (2, 6, 3))
    gt[:, :6, 7] = rng.randint(1, 4, (2, 6))
    batch = {"points": pts, "points_mask": np.ones((2, 2048), bool), "gt_boxes": gt}

    def trainer(seed):
        net = build_network(cfg.MODEL, meta, device=dev, seed=seed)
        opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
        state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device=dev)
        return state, make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device=dev)

    def tensors(state):
        opt = state.optimizer
        return ([*state.net.state_dict().values()]
                + [t for g in opt.param_groups for p in g["params"] for t in opt.state[p].values()]
                + [t for c in state.curriculum for t in c] + [state.conf_sum, state.conf_cnt])

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state, step = trainer(3)
        state, _ = step(state, batch, 0)
        path = save_checkpoint(state, tmp_path, 1, 1,
                               sampler_state={"confidence_groups": np.ones((3, 96), np.float32)})
        fresh, fresh_step = trainer(7)
        payload = load_checkpoint(path, fresh)
        assert payload["sampler"]["confidence_groups"].device == dev
        assert fresh.optimizer.count == state.optimizer.count == fresh.step == 1
        for a, b in zip(tensors(fresh), tensors(state)):
            assert a.device == b.device and torch.equal(a, b)
        state, m = step(state, batch, 0)
        fresh, fm = fresh_step(fresh, batch, 0)
        torch.cuda.synchronize()
        assert torch.equal(m["loss"], fm["loss"])
        for a, b in zip(tensors(fresh), tensors(state)):
            assert torch.equal(a, b)
    finally:
        torch.use_deterministic_algorithms(was)


def test_anchor_eval_step_matches_cpu(dev):
    """KITTI PointPillars' eval step at a 64x64 grid in f32: card (kernels,
    K4 at NMS_PRE_MAXSIZE 2,048 past the shared-memory layout) vs CPU
    (plain versions), same weights."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/kitti_models/pointpillar.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 2048
    pr = (0.0, -5.12, -3.0, 10.24, 5.12, 1.0)
    meta = DatasetMeta(cfg.CLASS_NAMES, pr, (0.16, 0.16, 4.0), (64, 64, 1), 4)
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(0, 10.24, (2, 8192, 1)),
                          rng.uniform(-5.12, 5.12, (2, 8192, 1)),
                          rng.uniform(-2.8, 0.8, (2, 8192, 1)), rng.rand(2, 8192, 1)],
                         -1).astype(np.float32)
    batch = {"points": pts, "points_mask": np.ones((2, 8192), bool)}
    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        with torch.no_grad():  # scores spread over (0, 1); box residuals small, as
            net.dense_head.conv_cls.bias.add_(4.0)  # pcdet's conv_box init makes them
            net.dense_head.conv_box.weight.mul_(0.02)
        before = nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert nms.launches == before + (d == dev)
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    assert gv.sum() > 20
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


# the sparse-voxel path: the engine and the voxel detectors, card against CPU

def _sparse_scene(seed, grid=(7, 10, 10), n=60, cin=6, v=72):
    """Random distinct sites in ``grid`` then invalid rows to ``v``."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = grid
    flat = rng.choice(nz * ny * nx, size=n, replace=False)
    coords = np.full((v, 3), -1, np.int32)
    coords[:n] = np.stack([flat // (ny * nx), (flat // nx) % ny, flat % nx], 1)
    return rng.randn(v, cin).astype(np.float32), coords, np.arange(v) < n


@pytest.mark.parametrize("dense", [True, False])
def test_sparse_engine_matches_cpu(dev, monkeypatch, dense):
    """Rulebooks and downsampled sites equal exactly, submanifold and strided
    convs (conv_out's anisotropic one too) forward and backward to 1e-4,
    through the dense table and through the sorted search."""
    from com_tpu_torch.ops import sparse as sp

    monkeypatch.setattr(sp, "DENSE_CELL_CAP", 10**12 if dense else 0)
    grid = (7, 10, 10)
    f, c, v = _sparse_scene(1, grid)
    w27 = np.random.RandomState(2).randn(27, 6, 8).astype(np.float32) * 0.3
    w3 = np.random.RandomState(3).randn(3, 6, 8).astype(np.float32) * 0.3
    convs = [
        ("subm", w27, lambda f_, c_, v_, w_: (sp.submanifold_conv3d(f_, c_, v_, w_, grid),)),
        ("strided", w27, lambda f_, c_, v_, w_: sp.strided_conv3d(f_, c_, v_, w_, grid, 40, 2)),
        ("conv_out", w3, lambda f_, c_, v_, w_: sp.strided_conv3d(
            f_, c_, v_, w_, grid, 60, (2, 1, 1), (3, 1, 1), 0))]
    for name, w, fn in convs:
        runs = []
        for d in (dev, "cpu"):
            ft = torch.from_numpy(f).to(d).requires_grad_()
            wt = torch.from_numpy(w).to(d).requires_grad_()
            out = fn(ft, torch.from_numpy(c).to(d), torch.from_numpy(v).to(d), wt)
            (out[0] * out[0]).sum().backward()
            runs.append([t.detach().cpu() if torch.is_tensor(t) else t
                         for t in (*out, ft.grad, wt.grad)])
        for a, b in zip(*runs):
            if not torch.is_tensor(a):
                assert a == b, name
            elif a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)
            else:
                assert torch.equal(a, b), name
    cd, vd = torch.from_numpy(c).to(dev), torch.from_numpy(v).to(dev)
    assert torch.equal(sp.subm_rulebook(cd, vd, grid).cpu(),
                       sp.subm_rulebook(torch.from_numpy(c), torch.from_numpy(v), grid))
    assert torch.equal(sp.strided_rulebook(cd, vd, grid, 20, 2)[0].cpu(),
                       sp.strided_rulebook(torch.from_numpy(c), torch.from_numpy(v), grid, 20,
                                           2)[0])


def _voxel_case(path, seed=0):
    """A YAML of the voxel path at a 64 x 64 x 40 grid (0.5 x 0.5 x 0.1 m
    over +-16 m), full widths, f32; two scenes of 4,000 points voxelized
    into 2,048 slots of 5 points (the points too, for a keypoint encoder),
    6 objects in 16 slots with the COM side arrays."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.ops.voxelize import voxelize_points
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(path)
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [2048, 1024, 512, 256]
    if "TARGET_ASSIGNER_CONFIG" in cfg.MODEL.DENSE_HEAD:
        cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 16
    pc_range, vsize = (-16.0, -16.0, -2.0, 16.0, 16.0, 2.0), (0.5, 0.5, 0.1)
    meta = DatasetMeta(cfg.CLASS_NAMES, pc_range, vsize, (64, 64, 40), 5)
    rng = np.random.RandomState(seed)
    vox = np.zeros((2, 2048, 5, 5), np.float32)
    coords = np.full((2, 2048, 3), -1, np.int32)
    num = np.zeros((2, 2048), np.int32)
    points = np.zeros((2, 4000, 5), np.float32)
    for i in range(2):
        pts = points[i] = np.concatenate([rng.uniform(-15, 15, (4000, 2)),
                                          rng.uniform(-1.4, 1.4, (4000, 1)),
                                          rng.rand(4000, 2)], 1).astype(np.float32)
        a, b, c = voxelize_points(pts, pc_range, vsize, 5, 2048)
        vox[i, :len(a)], coords[i, :len(a)], num[i, :len(a)] = a, b, c
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-12, 12, (2, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 4.0, (2, 6, 3))
    gt[:, :6, 6] = rng.uniform(-np.pi, np.pi, (2, 6))
    gt[:, :6, 7] = rng.randint(1, 4, (2, 6))
    batch = {"voxels": vox, "voxel_coords": coords, "voxel_num_points": num, "gt_boxes": gt,
             "num_points_in_gt": (gt[..., 7] > 0).astype(np.float32) * 10,
             "true_object": (gt[..., 7] > 0).astype(np.float32),
             "occupancy_ratio": rng.rand(2, 16).astype(np.float32),
             "facade_type": rng.randint(0, 4, (2, 16)).astype(np.float32),
             "points": points, "points_mask": np.ones((2, 4000), bool)}
    return cfg, meta, batch


@pytest.mark.parametrize("path", ["configs/waymo_models/com/centerpoint_voxel_comloss.yaml",
                                  "configs/kitti_models/second.yaml"])
def test_voxel_eval_step_matches_cpu(dev, path):
    """CenterPoint-voxel's and SECOND's eval steps at 64 x 64 x 40 in f32:
    card (K2 in the BEV backbone, K4) vs CPU, same weights."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = _voxel_case(path)
    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        if hasattr(net.dense_head, "conv_cls"):
            with torch.no_grad():  # scores spread, box residuals small
                net.dense_head.conv_cls.bias.add_(4.0)
                net.dense_head.conv_box.weight.mul_(0.02)
        before = conv2d.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert conv2d.launches == before + 11 * (d == dev)
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        if len(a):
            assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


@pytest.mark.parametrize("path", ["configs/kitti_models/voxel_rcnn_car.yaml",
                                  "configs/kitti_models/second_iou.yaml"])
def test_two_stage_eval_step_matches_cpu(dev, path):
    """Voxel-RCNN's and SECOND-IoU's eval steps at 64 x 64 x 40 in f32, the
    RoI heads at full width: card (K2 in the BEV backbone, K4 for the
    proposals and the final NMS) vs CPU, same weights, scores spread."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = _voxel_case(path, seed=4)
    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        with torch.no_grad():
            net.dense_head.conv_cls.bias.add_(4.0)
            net.dense_head.conv_box.weight.mul_(0.02)
        k2, k4 = conv2d.launches, nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert (conv2d.launches - k2, nms.launches - k4) == ((11, 2) if d == dev else (0, 0))
    (gb, gs, gl, gv), (cb, cs, cl, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    assert gv.sum() > 0
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None], gl[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None], cl[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


def test_pointnet2_on_card_matches_cpu(dev):
    """FPS, sector FPS and ball-query indices on the card equal the CPU's
    (the distances' terms are separate element-wise ops on both), the
    grouped features too, at KITTI-like sizes: 2 scenes of 32,768 points, a
    tenth masked, 4,096 keypoints, radii 0.8 and 4.8 m, blocks of query
    rows cut small on the card."""
    from com_tpu_torch.ops import pointnet2 as pn2

    rng = np.random.RandomState(17)
    xyz = np.concatenate([rng.uniform(0, 70, (2, 32768, 1)), rng.uniform(-40, 40, (2, 32768, 1)),
                          rng.uniform(-3, 1, (2, 32768, 1))], -1).astype(np.float32)
    feats = rng.rand(2, 32768, 4).astype(np.float32)
    valid = rng.rand(2, 32768) > 0.1
    c_xyz, c_valid = torch.from_numpy(xyz), torch.from_numpy(valid)
    g_xyz, g_valid = c_xyz.to(dev), c_valid.to(dev)
    idx = pn2.farthest_point_sample(g_xyz, g_valid, 4096)
    cpu_idx = pn2.farthest_point_sample(c_xyz, c_valid, 4096)
    mismatch = (idx.cpu() != cpu_idx).nonzero()
    assert len(mismatch) == 0, f"FPS differs first at (scene, sample) {mismatch[0].tolist()}"
    s_idx, s_ok = pn2.sector_fps(g_xyz, g_valid, 4096, 6)
    c_idx, c_ok = pn2.sector_fps(c_xyz, c_valid, 4096, 6)
    assert torch.equal(s_idx.cpu(), c_idx) and torch.equal(s_ok.cpu(), c_ok)
    kp = pn2.gather_points(c_xyz, cpu_idx)
    for radius, nsample in ((0.8, 16), (4.8, 16)):
        got = pn2.query_and_group(radius, nsample, g_xyz, kp.to(dev), torch.from_numpy(feats).to(
            dev), valid=g_valid, block=1 << 22)
        want = pn2.query_and_group(radius, nsample, c_xyz, kp, torch.from_numpy(feats),
                                   valid=c_valid)
        for name, a, b in zip(("grouped", "idx", "empty", "slot_valid"), got, want):
            assert torch.equal(a.cpu(), b), (radius, name)
        assert bool(want[3].any())
        if radius < 1:  # balls with fewer hits than slots
            assert not bool(want[3].all())


def test_pvrcnn_eval_step_matches_cpu(dev):
    """``kitti_models/pv_rcnn.yaml`` at 64 x 64 x 40 in f32, full widths
    (4,096 keypoints, a 6^3 RoI grid): card (K2 in the BEV backbone, K4 in
    the final NMS; the proposals are the top TEST_PRE, no NMS) vs CPU, same
    weights, scores spread: the keypoints exactly, the detections to 1e-3."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = _voxel_case("configs/kitti_models/pv_rcnn.yaml", seed=5)
    outs, keypoints = [], []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=3)
        with torch.no_grad():
            net.dense_head.conv_cls.bias.add_(4.0)
            net.dense_head.conv_box.weight.mul_(0.02)
        net.pfe.register_forward_hook(lambda m, a, out: keypoints.append(
            out["point_coords"].cpu()))
        k2, k4 = conv2d.launches, nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert (conv2d.launches - k2, nms.launches - k4) == ((11, 1) if d == dev else (0, 0))
    assert torch.equal(keypoints[0], keypoints[1])
    (gb, gs, gl, gv), (cb, cs, cl, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    assert gv.sum() > 0
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None], gl[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None], cl[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


def test_pointrcnn_eval_step_matches_cpu(dev):
    """``tests/test_pointrcnn.py``'s small PointRCNN
    (``chip_smoke.pointrcnn_small_case``) in f32: card (K4 in the proposal
    NMS and the final one) vs CPU, the same seeded weights, scores spread:
    the detections to 1e-3."""
    from chip_smoke import pointrcnn_small_case, spread_point_scores
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = pointrcnn_small_case(seed=2)
    outs = []
    for d in (dev, "cpu"):
        net = spread_point_scores(build_network(cfg.MODEL, meta, device=d, seed=3))
        k4 = nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert nms.launches - k4 == (2 if d == dev else 0)
    (gb, gs, gl, gv), (cb, cs, cl, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    assert gv.sum() > 0
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None], gl[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None], cl[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


def test_pointrcnn_train_step_matches_cpu(dev):
    """One step of the small PointRCNN in f32, norm biases +3: the card (K4
    in the proposal NMS) against the CPU, as ``chip_smoke``'s N.1 holds it
    (``compare_train_step`` with ``own_noise``: within the flagship's
    tolerances or twice either device's own difference with the scenes
    swapped; its RoI head's max pools and 32-row norms turn rounding into
    1e-5 of a batch statistic on one device alone)."""
    from chip_smoke import compare_train_step, pointrcnn_small_case

    cfg, meta, batch = pointrcnn_small_case(seed=4)
    compare_train_step(dev, cfg, meta, batch, "PointRCNN train step, card vs CPU",
                       counts_confidences=False, own_noise=True)


def test_roipoint_pool3d_on_card_matches_cpu(dev):
    """RoI point pooling at path N's serving size (2 scenes of 32,768
    points, a tenth masked, 100 RoIs, 512 slots): the same member points in
    the same slots (their indices ride in the first feature), the local
    coordinates to 1e-5, the empty flags; blocks of RoIs cut small on the
    card."""
    from com_tpu_torch.ops.roiaware import roipoint_pool3d

    rng = np.random.RandomState(23)
    xyz = np.concatenate([rng.uniform(0, 70, (2, 32768, 1)), rng.uniform(-40, 40, (2, 32768, 1)),
                          rng.uniform(-3, 1, (2, 32768, 1))], -1).astype(np.float32)
    feats = np.stack([np.broadcast_to(np.arange(32768, dtype=np.float32), (2, 32768)),
                      rng.rand(2, 32768).astype(np.float32)], -1)
    valid = rng.rand(2, 32768) > 0.1
    rois = np.concatenate([rng.uniform(0, 70, (2, 100, 1)), rng.uniform(-40, 40, (2, 100, 1)),
                           rng.uniform(-2, 0, (2, 100, 1)), rng.uniform(1, 12, (2, 100, 3)),
                           rng.uniform(-3.1, 3.1, (2, 100, 1))], -1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xyz, feats, valid, rois)]
    want, want_empty = roipoint_pool3d(*args, 512)
    got, got_empty = roipoint_pool3d(*(a.to(dev) for a in args), 512, block=1 << 21)
    assert torch.equal(got_empty.cpu(), want_empty)
    assert torch.equal(got[..., 3:].cpu(), want[..., 3:])
    assert float((got[..., :3].cpu() - want[..., :3]).abs().max()) <= 1e-5
    members = (want.abs().sum(-1) > 0).sum(-1)
    assert bool((members == 512).any()) and bool(((members > 0) & (members < 512)).any())


def test_roiaware_pool3d_on_card_matches_cpu(dev):
    """RoI-aware pooling at path O's serving size (4 scenes of 40,000 voxel
    centres with 16 features, a tenth masked, 100 RoIs, POOL_SIZE 12, 512
    points a RoI): ``max`` exactly, ``avg`` to 1e-6 of the features' size
    (the card adds a cell's members in another order); blocks of RoIs cut
    small on the card."""
    from com_tpu_torch.ops.roiaware import roiaware_pool3d

    rng = np.random.RandomState(29)
    xyz = np.concatenate([rng.uniform(0, 70, (4, 40000, 1)), rng.uniform(-40, 40, (4, 40000, 1)),
                          rng.uniform(-3, 1, (4, 40000, 1))], -1).astype(np.float32)
    feats = rng.randn(4, 40000, 16).astype(np.float32)
    valid = rng.rand(4, 40000) > 0.1
    rois = np.concatenate([rng.uniform(0, 70, (4, 100, 1)), rng.uniform(-40, 40, (4, 100, 1)),
                           rng.uniform(-2, 0, (4, 100, 1)), rng.uniform(1, 12, (4, 100, 3)),
                           rng.uniform(-3.1, 3.1, (4, 100, 1))], -1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (xyz, feats, valid, rois)]
    for method in ("max", "avg"):
        want = roiaware_pool3d(*args, 12, 512, method)
        got = roiaware_pool3d(*(a.to(dev) for a in args), 12, 512, method, block=1 << 21).cpu()
        if method == "max":
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= 1e-6 * float(np.abs(feats).max())
        filled = want.abs().sum(-1) > 0
        assert bool(filled.any()) and not bool(filled.all())


def test_parta2_eval_step_matches_cpu(dev):
    """PartA2 narrowed as the CPU tests narrow it (``chip_smoke.
    parta2_small_case``) in f32: card (K2 in the BEV backbone, K4 in the
    proposal NMS and the final one) vs CPU, the same seeded weights, norm
    biases +3 (the UNet's dense tensor is ~1e-5 at the seeded init: every
    anchor would score alike) and anchor scores spread: the detections to
    1e-3."""
    from chip_smoke import parta2_small_case, shift_norm_biases, spread_anchor_scores
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = parta2_small_case(seed=2)
    b2 = cfg.MODEL.BACKBONE_2D
    k2_expect = sum(n + (s == 1) for n, s in zip(b2.LAYER_NUMS, b2.LAYER_STRIDES))
    outs = []
    for d in (dev, "cpu"):
        net = spread_anchor_scores(shift_norm_biases(build_network(cfg.MODEL, meta, device=d,
                                                                   seed=3)))
        k2, k4 = conv2d.launches, nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert (conv2d.launches - k2, nms.launches - k4) == ((k2_expect, 2) if d == dev
                                                             else (0, 0))
    (gb, gs, gl, gv), (cb, cs, cl, cv) = outs
    np.testing.assert_array_equal(gv, cv)
    assert gv.sum() > 0
    for i in range(2):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None], gl[i][gv[i]][:, None]], -1)
        c = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None], cl[i][cv[i]][:, None]], -1)
        assert np.abs(a[:, None] - c[None]).max(-1).min(1).max() <= 1e-3


def test_parta2_train_step_matches_cpu(dev):
    """One step of the narrowed PartA2 in f32, norm biases +3: the card (K2,
    dgrad and K2w in the BEV backbone, K4 in the proposal NMS) against the
    CPU, as ``chip_smoke``'s O.1 holds it (``compare_train_step`` with
    ``own_noise``: its RoI head's norms over 32 RoIs)."""
    from chip_smoke import compare_train_step, parta2_small_case, spread_anchor_scores

    cfg, meta, batch = parta2_small_case(seed=4)
    compare_train_step(dev, cfg, meta, batch, "PartA2 train step, card vs CPU",
                       counts_confidences=False, own_noise=True, prepare=spread_anchor_scores)


def test_k4_in_the_parta2_proposal_layer(dev):
    """PartA2's serving proposals at full size: (4, 1024) candidates of the
    anchor head through the proposal layer (NMS_THRESH 0.7 -> 100 RoIs):
    K4 launched once, the RoIs as the CPU's."""
    from com_tpu_torch.models.roi_heads.proposal_layer import proposal_layer

    rng = np.random.RandomState(31)
    centres = rng.uniform(-40, 40, (4, 200, 2))
    pick = rng.randint(0, 200, (4, 3000))
    boxes = np.zeros((4, 3000, 7), np.float32)
    boxes[..., :2] = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.6,
                                                                                  (4, 3000, 2))
    boxes[..., 3:6] = [3.9, 1.6, 1.56]
    boxes[..., 6] = rng.uniform(-3.1, 3.1, (4, 3000))
    scores = rng.rand(4, 3000).astype(np.float32)
    labels = rng.randint(1, 4, (4, 3000)).astype(np.int32)
    outs = []
    for d in (dev, "cpu"):
        k4 = nms.launches
        out = proposal_layer(*(torch.from_numpy(a).to(d) for a in (boxes, scores, labels)),
                             nms_pre=1024, nms_post=100, nms_thresh=0.7)
        assert nms.launches - k4 == (1 if d == dev else 0)
        outs.append([t.cpu() for t in out])
    (gr, gs, gl, gv), (cr, cs, cl, cv) = outs
    assert torch.equal(gv, cv) and int(gv.sum()) > 100
    assert torch.equal(gl, cl) and float((gr - cr).abs().max()) <= 1e-5


def test_centerhead_rpn_eval_step_matches_cpu(dev):
    """Voxel-RCNN with the CenterHead RPN and DynamicMeanVFE narrowed as the
    CPU tests narrow it (``chip_smoke.centerhead_small_case``) in f32: card
    (K2 in the BEV backbone, K4 in the proposal NMS and the final one)
    against the CPU, the same seeded weights, norm biases +3 and the
    heatmap spread: the detections to 1e-3."""
    from chip_smoke import (centerhead_small_case, check_detections, shift_norm_biases,
                            spread_center_scores)
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch = centerhead_small_case("voxel_rcnn", seed=2)
    outs = []
    for d in (dev, "cpu"):
        net = spread_center_scores(shift_norm_biases(build_network(cfg.MODEL, meta, device=d,
                                                                   seed=3)))
        k2, k4 = conv2d.launches, nms.launches
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        assert (conv2d.launches - k2, nms.launches - k4) == ((3, 2) if d == dev else (0, 0))
    assert outs[1][3].sum() > 0
    check_detections("CenterHead-RPN Voxel-RCNN eval step, card vs CPU", *outs)


def test_centerhead_rpn_train_step_matches_cpu(dev):
    """One step of the narrowed Voxel-RCNN with the CenterHead RPN in f32,
    norm biases +3, GT a little off its own proposals: the card (K2, dgrad
    and K2w, K3 for the heatmap targets, K4 in the proposal NMS) against
    the CPU, as ``chip_smoke``'s P.1 holds it."""
    from chip_smoke import (centerhead_small_case, compare_train_step, follow_proposals,
                            spread_center_scores)

    cfg, meta, batch = centerhead_small_case("voxel_rcnn", seed=4)
    compare_train_step(dev, cfg, meta, batch, "CenterHead-RPN Voxel-RCNN train step, card vs CPU",
                       counts_confidences=False, own_noise=True,
                       prepare=lambda net: follow_proposals(spread_center_scores(net),
                                                            per_scene=2, off=True))


def test_mppnet_e2e_eval_and_stream_match_cpu(dev):
    """MPPNetE2E narrowed (``centerhead_small_case("mppnet")``) in f32: the
    single-frame eval step and a 3-frame stream through ``make_stream_step``
    on the card (K2, K4 in the final NMS) against the CPU, each frame's
    detections to 1e-3."""
    from chip_smoke import (centerhead_small_case, compare_eval_step, compare_stream,
                            shift_norm_biases, spread_center_scores)

    def prep(net):
        return spread_center_scores(shift_norm_biases(net))

    cfg, meta, frames = centerhead_small_case("mppnet", seed=6, frames=3)
    k4 = nms.launches
    compare_eval_step(dev, cfg, meta, frames[0], "MPPNetE2E eval step, card vs CPU", prepare=prep)
    compare_stream(dev, cfg, meta, frames, "MPPNetE2E stream, card vs CPU", prepare=prep)
    assert nms.launches - k4 == 4  # one final NMS a forward on the card


def test_k4_in_the_centerhead_proposal_layer(dev):
    """The CenterHead RPN's proposals at full size: a (4, 188, 188, 3)
    heatmap's top 512 a scene (``decode_center_proposals``) through the
    proposal layer (NMS_THRESH 0.7 -> 100 RoIs, the invalid ones at -inf):
    K4 launched once, the RoIs as the CPU's."""
    from com_tpu_torch.models.dense_heads.center_head import decode_center_proposals
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.models.roi_heads.proposal_layer import proposal_layer

    rng = np.random.RandomState(37)
    widths = {"hm": 3, "center": 2, "center_z": 1, "dim": 3, "rot": 2}
    pred = {k: rng.randn(4, 188, 188, w).astype(np.float32) for k, w in widths.items()}
    pred["dim"] *= 0.1
    pred["hm"] = pred["hm"] * 1.5 - 2.0
    dh = {"TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 8},
          "CLASS_NAMES_EACH_HEAD": [["Vehicle", "Pedestrian", "Cyclist"]],
          "SEPARATE_HEAD_CFG": {"HEAD_ORDER": ["center", "center_z", "dim", "rot"]}}
    meta = DatasetMeta(("Vehicle", "Pedestrian", "Cyclist"), (-74.88, -74.88, -2, 74.88, 74.88, 4),
                       (0.1, 0.1, 0.15), (1498, 1498, 40), 5)
    outs = []
    for d in (dev, "cpu"):
        boxes, scores, labels, valid = decode_center_proposals(
            {"pred_dicts": [{k: torch.from_numpy(v).to(d) for k, v in pred.items()}]}, dh, meta)
        assert boxes.shape == (4, 512, 7)
        k4 = nms.launches
        out = proposal_layer(boxes, torch.where(valid, scores, torch.full_like(scores, -math.inf)),
                             labels, nms_pre=512, nms_post=100, nms_thresh=0.7)
        assert nms.launches - k4 == (1 if d == dev else 0)
        outs.append([t.cpu() for t in out])
    (gr, gs, gl, gv), (cr, cs, cl, cv) = outs
    assert torch.equal(gv, cv) and int(gv.sum()) > 100
    assert torch.equal(gl, cl) and float((gr - cr).abs().max()) <= 1e-4


@pytest.mark.parametrize("k", [4096, 1024, 100])
def test_k4_at_the_proposal_shapes(dev, k):
    """K4 at the two-stage path's (2, 4096) train and (2, 1024) serving
    proposals and its (2, 100) final NMS, on the overlaps of clustered
    rotated boxes in score order (thresholds 0.8 and 0.7): the keep mask
    exactly as the plain version's."""
    from com_tpu_torch.ops.iou import boxes_iou_bev

    rng = np.random.RandomState(k)
    centres = rng.uniform(-40, 40, (2, k // 8 + 1, 2))
    pick = rng.randint(0, centres.shape[1], (2, k))
    boxes = np.zeros((2, k, 7), np.float32)
    boxes[..., :2] = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 0.5, (2, k, 2))
    boxes[..., 3:6] = [3.9, 1.6, 1.56]
    boxes[..., 6] = rng.choice([0.0, 1.57], (2, k)) + rng.normal(0, 0.1, (2, k))
    sb = torch.from_numpy(boxes).to(dev)
    for thresh in (0.8, 0.7):
        over = torch.cat([(boxes_iou_bev(sb[i:i + 1], sb[i:i + 1]) > thresh)
                          for i in range(2)]).contiguous()
        valid = torch.from_numpy(rng.rand(2, k) < 0.95).to(dev)
        before = nms.launches
        got = nms.greedy_suppress(over, valid)
        assert nms.launches == before + 1
        want = nms.greedy_suppress_plain(over, valid)
        assert torch.equal(got, want) and 0 < int(got.sum()) < int(valid.sum())


def test_voxel_train_step_matches_cpu(dev):
    """One CenterPoint-voxel COMLoss step (UCL on) at 64 x 64 x 40 in f32,
    norm biases moved by 3: card vs CPU, as the pillar step above."""
    cfg, meta, batch = _voxel_case("configs/waymo_models/com/centerpoint_voxel_comloss.yaml")
    assert cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL
    _step_card_against_cpu(dev, cfg, meta, batch, bias_shift=3.0)


# the registered ops (torch.library) on the card, and an exported program

def _op_cases(dev):
    """(op, args, plain result) at small ragged shapes on the card."""
    rng = np.random.RandomState(11)
    seg = torch.from_numpy(np.sort(rng.randint(0, 30, (2, 700)), axis=1).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.randn(2, 700, 8).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(2, 9, 70, 16).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(3, 3, 16, 24).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(2, 9, 70, 24).astype(np.float32)).to(dev)
    over = torch.from_numpy(rng.rand(2, 130, 130) < 0.05).to(dev)
    valid = torch.from_numpy(rng.rand(2, 130) < 0.9).to(dev)
    out = seg_scan.run_bcast_plain(vals, seg, "max")
    ops = torch.ops.com_tpu_torch
    return [
        (ops.run_bcast, (vals, seg, "sum"), seg_scan.run_bcast_plain(vals, seg, "sum")),
        (ops.run_bcast, (vals, seg, "max"), out),
        (ops.run_bcast_bwd, (vals, seg, None, None), seg_scan.run_bcast_plain(vals, seg, "sum")),
        (ops.run_bcast_bwd, (vals, seg, vals, out),
         seg_scan.run_bcast_max_bwd_plain(vals, vals, out, seg)),
        (ops.conv3x3, (x, w, False), conv2d.conv3x3_plain(x, w)),
        (ops.conv3x3, (g, w, True), conv2d.conv3x3_plain(g, conv2d.rotate_kernel(w))),
        (ops.conv3x3_wgrad, (x, g), conv2d.conv3x3_wgrad_plain(x, g)),
        (ops.greedy_suppress, (over, valid), nms.greedy_suppress_plain(over, valid)),
    ]


@pytest.mark.parametrize("case", range(8), ids=["k1_sum", "k1_max", "k1_sum_bwd", "k1_max_bwd",
                                                 "k2", "k2_dgrad", "k2w", "k4"])
def test_registered_op_on_card_matches_plain(dev, case):
    """Each registered op on CUDA tensors launches its kernel (one count on
    its counter) and agrees with the plain version in f32: K1 max and K4
    exactly; the sums, the max backward's split of a run's sum and the convs
    to f32 rounding."""
    op, args, want = _op_cases(dev)[case]
    counters = [(seg_scan, "launches"), (seg_scan, "bwd_launches"), (conv2d, "launches"),
                (conv2d, "dgrad_launches"), (conv2d, "wgrad_launches"), (nms, "launches")]
    before = [getattr(m, a) for m, a in counters]
    got = op(*args)
    torch.cuda.synchronize()
    assert sum(getattr(m, a) for m, a in counters) == sum(before) + 1
    if want.dtype == torch.bool or case == 1:
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(want.abs().max().item(), 1.0), err


def test_exported_program_launches_the_kernels(dev, tmp_path):
    """The flagship eval step at a 32x32 grid in f32 exported on the card,
    written, loaded and run: its outputs equal the eager step's, and one
    forward launches K1 twice, K2 14 times and K4 once."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.config import cfg_from_yaml_file
    from com_tpu_torch.utils.serving import (export_eval_step, load_artifact, make_manifest,
                                             write_artifact)

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    meta = DatasetMeta(cfg.CLASS_NAMES, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0),
                       (0.32, 0.32, 6.0), (32, 32, 1), 5)
    spec = {"points": ((2, 2048, 5), torch.float32), "points_mask": ((2, 2048), torch.bool)}
    net = build_network(cfg.MODEL, meta, device=dev, seed=3)
    program = export_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, spec, device=dev)
    write_artifact(tmp_path / "model", program, make_manifest(cfg, meta, spec, ["cuda"]))
    run, manifest = load_artifact(tmp_path / "model", device=dev)
    assert manifest["platforms"] == ["cuda"]
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (2, 2048))
    batch = {"points": pts, "points_mask": np.ones((2, 2048), bool)}
    want = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)(batch)
    before = (seg_scan.launches, conv2d.launches, nms.launches)
    got = run(batch)
    torch.cuda.synchronize()
    after = (seg_scan.launches, conv2d.launches, nms.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 14, 1)
    for g, w in zip(got, want):
        assert g.device == w.device and torch.equal(g, w)


def test_data_parallel_step_on_card_matches_one_process(dev, tmp_path):
    """Path I.1 small: the tiny flagship (32x32 grid, f32, norm biases +3)
    on two gloo ranks spawned on the card, a scene each, against one process
    on both scenes: the ranks bitwise equal; loss, batch statistics,
    curriculum, confidence sums (counts exact) and the parameters where
    |g| is not tiny within the CPU parity tests' tolerances; K1, K2, K2w and
    K3 launched on each rank."""
    import torch_port_parallel_worker as worker
    from com_tpu_torch.parallel.launch import run_ranks

    case = worker.tiny_case(device=str(dev), bias_shift=3.0)
    one = worker.run_step(case, case["batch"])
    torch.save(case, tmp_path / "spec.pt")
    run_ranks(worker.card_worker, 2, args=(str(tmp_path / "spec.pt"), str(tmp_path)),
              device=str(dev), threads=2, init_dir=tmp_path)
    ranks = []
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    for k, v in ranks[0].items():
        if not k.startswith("local/"):  # the ranks' own gradients, before the reduction
            np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)
    got = ranks[0]
    assert abs(float(got["loss"]) - float(one["loss"])) <= 1e-5 * abs(float(one["loss"]))
    np.testing.assert_array_equal(got["conf_cnt"], one["conf_cnt"])
    assert one["conf_cnt"].sum() > 0
    np.testing.assert_allclose(got["conf_sum"], one["conf_sum"], rtol=1e-5, atol=1e-5)
    for k, want in one["stats"].items():
        np.testing.assert_allclose(got[f"stats/{k}"], want, rtol=1e-5, atol=1e-5, err_msg=k)
    for k, want in one["cur"].items():
        np.testing.assert_allclose(got[f"cur/{k}"], want, rtol=1e-5, atol=1e-7, err_msg=k)
    gmax = max(np.abs(g).max() for g in one["grads"].values())
    for k, g in one["grads"].items():
        np.testing.assert_allclose(got[f"grads/{k}"], g, rtol=1e-4,
                                   atol=1e-6 * np.abs(g).max() + 1e-5 * gmax, err_msg=k)
        sure = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > 1e-4 * gmax)
        np.testing.assert_allclose(got[f"params/{k}"][sure], one["params"][k][sure], rtol=0,
                                   atol=1e-6, err_msg=k)
    for k in ("k1", "k1_bwd", "k2", "k2_dgrad", "k2w", "k3"):
        assert got[f"launches/{k}"] > 0 and got[f"launches/{k}"] == one["launches"][k], k


def test_nuscenes_centerpoint_eval_step_matches_cpu(dev, tmp_path):
    """``nuscenes_models/cbgs_dyn_pp_centerpoint.yaml`` at its width on a
    64 x 64 x 1 grid in f32, fed by the port's loader from a seeded nuScenes
    tree (``chip_smoke.q_small_case``): the card (K1's sum and max in the
    pillar VFE, K2 in the BEV backbone, K4 once a head group) against the
    CPU, the same seeded weights, norm biases +3 and the heatmaps spread:
    the detections to 1e-3."""
    from chip_smoke import (check_detections, q_small_case, shift_norm_biases,
                            spread_center_scores)
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, batch, _ = q_small_case("nuscenes", tmp_path, seed=5)
    outs = []
    for d in (dev, "cpu"):
        net = spread_center_scores(shift_norm_biases(build_network(cfg.MODEL, meta, device=d,
                                                                   seed=6)))
        before = (seg_scan.launches, conv2d.launches, nms.launches)
        outs.append([t.cpu().numpy() for t in make_eval_step(
            net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)(batch)])
        ran = tuple(a - b for a, b in zip((seg_scan.launches, conv2d.launches, nms.launches),
                                          before))
        assert ran == ((2, 13, 6) if d == dev else (0, 0, 0))
    assert outs[1][3].sum() > 100
    check_detections("nuScenes CenterPoint-pillar eval step, card vs CPU", *outs)


def test_k1_at_the_nuscenes_vfe_shape(dev):
    """K1 at the nuScenes pillar VFE's shapes, (4, 262144, C) over a 512 x 512
    grid of 0.2 m pillars, points denser near the sensor: the cluster sum
    (f32, 8 channels), the max (bf16, 32) and its fused backward, against
    the plain versions; one launch each."""
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    rng = np.random.RandomState(41)
    b, n = 4, 262144
    r = 1.0 + 47.0 * rng.rand(b, n) ** 2
    az = rng.uniform(-np.pi, np.pi, (b, n))
    xyz = np.stack([r * np.cos(az), r * np.sin(az), rng.uniform(-2.0, 1.0, (b, n))], -1)
    pts = torch.from_numpy(xyz.astype(np.float32)).to(dev)
    flat, _ = point_voxel_ids(pts, (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0), (0.2, 0.2, 8.0),
                              (512, 512, 1))
    seg, order = torch.sort(flat, dim=1)
    seg = seg.contiguous()
    sxyz = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
    vals = torch.cat([sxyz, torch.ones_like(sxyz[..., :1]), torch.zeros_like(sxyz),
                      torch.zeros_like(sxyz[..., :1])], -1).contiguous()
    before = seg_scan.launches
    got = seg_scan.run_bcast(vals, seg, "sum")
    assert seg_scan.launches == before + 1
    want = seg_scan.run_bcast_plain(vals, seg, "sum")
    scale = seg_scan.run_bcast_plain(vals.abs(), seg, "sum")
    assert bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
    gen = torch.Generator(device=dev).manual_seed(42)
    x = ((torch.randn((b, n, 32), device=dev, generator=gen) * 2).round() / 2).to(torch.bfloat16)
    assert torch.equal(seg_scan.run_bcast(x, seg, "max"), seg_scan.run_bcast_plain(x, seg, "max"))
    g = torch.randn((b, n, 32), device=dev, generator=gen).to(torch.bfloat16)
    out = seg_scan.run_bcast_plain(x, seg, "max")
    before = seg_scan.bwd_launches
    got = seg_scan.run_bcast_max_bwd(g, x, out, seg)
    assert seg_scan.bwd_launches == before + 1
    want = seg_scan.run_bcast_max_bwd_plain(g, x, out, seg)
    scale = seg_scan.run_bcast_plain(g.float().abs(), seg, "sum")
    err = (got.float() - want.float()).abs()
    assert bool((err <= 1e-5 * scale + 2.0 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.parametrize("config", ["configs/waymo_models/mppnet_4frames.yaml",
                                    "configs/waymo_models/mppnet_16frames.yaml"])
def test_mppnet_on_card_matches_cpu(dev, config):
    """MPPNet at the YAML's head widths over few points and RoIs
    (``chip_smoke.mppnet_width_case``) in f32, the card against the CPU
    (``compare_mppnet``): the trajectory linking, the eval step's
    detections (K4 once in its final NMS), the train-mode targets and one
    step's loss and gradients."""
    from chip_smoke import compare_mppnet, mppnet_width_case

    cfg, meta, batch = mppnet_width_case(config, seed=4)
    k4 = nms.launches
    compare_mppnet(dev, cfg, meta, batch, f"MPPNet ({config}), card vs CPU")
    assert nms.launches - k4 == 1  # the card's eval step: one final NMS


def test_com_feedback_reaches_the_sampler_through_the_train_cli(dev, tmp_path):
    """The flagship's YAML (DATA_PATH and DB_INFO_PATH set) over a small
    Waymo tree prepared by the port (``dataset_trees.write_waymo_tree``,
    ``create_data``'s create_gt_database and annotate_database), 2 epochs
    through the train CLI on the card: the dataset's COM2 sampler ends
    holding the last epoch's (3, 96) confidences, bitwise those of
    ``checkpoint_epoch_2.pth``, and every step launched path A's kernels."""
    from chip_smoke import EXPECT_TRAIN, read_counters, reset_counters, s_yaml
    from com_tpu_torch.tools import create_data, train
    from com_tpu_torch.tools.dataset_trees import write_waymo_tree
    from com_tpu_torch.utils.checkpoint import load_checkpoint, sampler_confidences
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    tree = tmp_path / "tree"
    write_waymo_tree(tree, seed=3, num_train=10, num_val=2, num_points=40000, objects=(20, 30))
    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    create_data.main(["--func", "create_gt_database", "--cfg_file",
                      str(s_yaml(tmp_path / "prep.yaml", cfg, tree))])
    create_data.main(["--func", "annotate_database", "--db_info_path",
                      str(tree / "waymo_dbinfos_train.pkl")])
    yaml_path = s_yaml(tmp_path / "train.yaml", cfg, tree,
                       db_info="waymo_dbinfos_train_annotated.pkl")
    seen = {}
    reset_counters()
    out = train.main(["--cfg_file", str(yaml_path), "--epochs", "2", "--device", "cuda",
                      "--workers", "1", "--output_dir", str(tmp_path / "out")],
                     on_start=lambda info: seen.update(dataset=info["dataset"]))
    torch.cuda.synchronize()
    steps = out["iterations"]
    assert steps == 2 * 2  # 4 frames after SAMPLED_INTERVAL 5, batch 2
    counts = read_counters()
    assert all(counts[k] == EXPECT_TRAIN.get(k, 0) * steps for k in counts), counts
    conf = seen["dataset"].data_augmentor.gt_sampler.confidence_groups
    want = sampler_confidences(load_checkpoint(out["ckpt_dir"] / "checkpoint_epoch_2.pth",
                                               map_location="cpu"))
    assert conf.shape == want.shape == (3, 96) and conf.dtype == np.float32
    assert conf.tobytes() == want.tobytes() and np.isfinite(conf).all() and conf.any()


@pytest.mark.parametrize("case", ["caddn", "focal"])
def test_image_models_eval_step_on_card_match_cpu(dev, case):
    """``chip_smoke``'s small CaDDN and focal multimodal models (path U.1),
    the card's eval-mode forward against the CPU's: the voxel volume and the
    head's outputs within 1e-4 of their largest magnitude; the focal convs'
    voxel sets exact (the focal model's norm biases +3, as path U.1)."""
    from chip_smoke import (caddn_small_case, card_vs_cpu_forward, focal_small_case,
                            shift_norm_biases)

    cfg, meta, batch = (caddn_small_case if case == "caddn" else focal_small_case)()
    card, cpu = card_vs_cpu_forward(dev, cfg, meta, batch, case, (
        "encoded_spconv_tensor", "cls_preds_raw", "box_preds_raw"),
        prepare=shift_norm_biases if case == "focal" else None)
    for a, b in zip(card.get("focal_coords", []), cpu.get("focal_coords", [])):
        assert torch.equal(a.cpu(), b)


def test_focal_split_and_spawn_on_card_matches_cpu(dev):
    """Spawned voxels, their slots and validity exact with tied scores."""
    from com_tpu_torch.ops.sparse import focal_split_and_spawn

    rng = np.random.RandomState(2)
    b, v, grid = 2, 3000, (9, 40, 40)
    coords = np.stack([rng.randint(0, g, (b, v)) for g in grid], -1).astype(np.int32)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        valid[i, np.unique(coords[i] @ np.array([1600, 40, 1]), return_index=True)[1]] = True
    args = (rng.randn(b, v, 8).astype(np.float32), coords, valid,
            np.round(rng.randn(b, v, 27) * 2).astype(np.float32))
    got, want = (focal_split_and_spawn(*(torch.as_tensor(a, device=d) for a in args), grid, 0.5,
                                       500) for d in (dev, "cpu"))
    assert int(want[2][:, v:].sum()) > 0
    for g, w in zip(got[1:3], want[1:3]):
        assert torch.equal(g.cpu(), w)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[3].cpu(), want[3], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 94, 311, 64), (2, 94, 70, 128), (1, 47, 35, 256)])
def test_conv3x3_at_the_image_models_shapes(dev, shape):
    """K2 forward, dgrad and K2w in f32 at SemSegEncoder's unpadded KITTI
    width (311, odd) and CaDDN's BEV shapes, against the plain versions'
    autograd."""
    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((b, h, w, c), device=dev, generator=gen, requires_grad=True)
    k = (torch.randn((3, 3, c, c), device=dev, generator=gen) / math.sqrt(9 * c)).requires_grad_()
    g = torch.randn((b, h, w, c), device=dev, generator=gen)
    y = conv2d.conv3x3(x, k)
    dx, dk = torch.autograd.grad(y, (x, k), g)
    xp, kp = x.detach().clone().requires_grad_(), k.detach().clone().requires_grad_()
    yp = conv2d.conv3x3_plain(xp, kp)
    dxp, dkp = torch.autograd.grad(yp, (xp, kp), g)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dx, dxp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(dk, dkp, rtol=1e-4, atol=1e-2)


def test_two_stage_mesh_on_card_matches_one_process(dev):
    """Path T at a 12.8 m range: Voxel-RCNN in f32 on two ranks sharing the
    card over gloo against one process over the global batch of 4
    (``chip_smoke.t_check``: loss and terms 1e-4, statistics, gradient)."""
    import shutil

    import chip_smoke as cs
    from com_tpu_torch.parallel.launch import run_ranks

    pr = (0, -6.4, -3, 12.8, 6.4, 1)
    one = cs.t_step(dev, cs.t_case(pr, 4096, 3000))
    out = cs.T_DIR.with_name("path_t_test")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    try:
        run_ranks(cs.t_rank, 2, args=(str(out), pr, 4096, 3000), device=str(dev),
                  init_dir=out, threads=2)
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    cs.t_check(one, ranks, "")
