"""The wgrad-formulation sweep's kernels T1-T4 against the JAX package's
microbenchmark, on the CPU.

Same numpy-seeded bf16 inputs into both.  JAX runs each Pallas kernel of
``tools/perf/microbench_wgrad_kernels.py`` in interpret mode: the module's
``pl`` is swapped, for the test only, for a namespace whose ``pallas_call``
interprets (the shared pallas module is left alone).  The port runs each
variant's plain version on CPU tensors, through the wrapper that launches
the kernel on the card.  Heights are not multiples of th (the pad rows),
cin differs from cout and h from w (a flipped tap shows).  Tolerance:
1e-5 * sum |x||g| element by element, both against each other and against
the JAX oracle; bf16 products are exact in f32, so only the order of f32
sums differs.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from com_tpu_torch.ops import conv2d, wgrad_variants
from com_tpu_torch.tools.perf import microbench_wgrad_kernels as port_mb
from tools.perf import microbench_wgrad_kernels as mb

torch.set_num_threads(2)

VARIANTS = ("gcol", "xcol", "gt9", "gtcol")


@pytest.fixture
def interpret(monkeypatch):
    ns = types.SimpleNamespace(**vars(pl))
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(mb, "pl", ns)


def _inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, cin)) * 0.3).astype(np.float32)
    g = (rng.standard_normal((b, h, w, cout)) * 0.3).astype(np.float32)
    xj, gj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(g).astype(jnp.bfloat16)
    # the same bf16 values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, gj, xt, gt


@pytest.mark.parametrize("th", [8, 16])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 20, 12, 8, 16), (1, 19, 10, 16, 8)])
def test_wgrad_variant_matches_jax(interpret, variant, th, b, h, w, cin, cout):
    xj, gj, xt, gt = _inputs(b * 100 + h, b, h, w, cin, cout)
    want = np.asarray(getattr(mb, f"wgrad_{variant}")(xj, gj, th))
    ref = np.asarray(mb.oracle(xj, gj))
    before = getattr(wgrad_variants, f"{variant}_launches")
    got = getattr(wgrad_variants, f"wgrad_{variant}")(xt, gt, th)
    assert getattr(wgrad_variants, f"{variant}_launches") == before  # the CPU launches nothing
    assert got.dtype == torch.float32 and got.shape == (3, 3, cin, cout)
    got = got.numpy()
    tol = 1e-5 * wgrad_variants.oracle(xt.float().abs(), gt.float().abs()).numpy()
    assert want.shape == got.shape
    assert (np.abs(got - want) <= tol).all()
    assert (np.abs(got - ref) <= tol).all()
    assert (np.abs(want - ref) <= tol).all()
    # the flipped gradient is far off: the check can see a wrong shift
    assert not (np.abs(got[::-1, ::-1] - ref) <= tol).all()


@pytest.mark.parametrize("b,h,w,cin,cout,th,resident", [
    (2, 468, 468, 64, 64, 8, 264), (2, 468, 468, 64, 64, 16, 264),
    (2, 468, 468, 128, 64, 8, 264), (2, 468, 468, 128, 64, 16, 132),
    (2, 24, 468, 128, 64, 16, 264), (1, 1, 65, 256, 256, 8, 264), (2, 5, 128, 192, 64, 16, 264),
    (1, 7, 64, 8, 8, 4, 1), (3, 9, 700, 8, 8, 4, 10_000)])
def test_xcol_gtcol_plan_covers_every_segment_once(b, h, w, cin, cout, th, resident):
    """The kernels' chunks: none empty, every row segment in exactly one,
    boundaries on multiples of th rows of a sample, at most one wave of the
    resident blocks, and the wrapper's scratch one partial a chunk."""
    chunks, tiles, segs = wgrad_variants.xcol_gtcol_plan(b, h, w, cin, cout, th, resident)
    extents = wgrad_variants.chunk_extents(b, h, w, th, tiles, segs)
    assert len(extents) == chunks >= 1
    seen = np.zeros((b * h, -(-w // wgrad_variants.SEGMENT)), int)
    for r0, r1, s0, s1 in extents:
        assert r0 < r1 and s0 < s1
        assert r0 % h % th == 0 and r1 % h % th == 0
        seen[r0:r1, s0:s1] += 1
    assert (seen == 1).all()
    blocks = 3 * -(-cin // 64) * -(-cout // 64)
    assert chunks * blocks <= max(resident, blocks)
    assert wgrad_variants.launch_plan(b, h, w, cin, cout, th, resident) == (
        (chunks, 9 * cin * cout), (tiles, segs))


@pytest.mark.parametrize("th", [8, 16])
@pytest.mark.parametrize("cin", [64, 128])
def test_launch_plan_gives_t1_t3_chunked_scratch(cin, th):
    """T1 and T3 take the chunked plan of T2 and T4: at the sweep's shapes
    their scratch is one partial a chunk, the chunks' blocks more than half
    of one wave of 264 resident blocks (two blocks an SM) and at most all of
    it, where their first kernels had one partial a row tile (B * ceil(H /
    th)) and 1.3-2.7 waves; the C entry gets (row tiles, segments) a
    chunk."""
    b, h, w, cout, resident = 2, 468, 468, 64, 264
    (parts, n), plan = wgrad_variants.launch_plan(b, h, w, cin, cout, th, resident)
    chunks, tiles, segs = wgrad_variants.xcol_gtcol_plan(b, h, w, cin, cout, th, resident)
    assert (parts, n) == (chunks, 9 * cin * cout) and plan == (tiles, segs)
    assert resident // 2 < parts * 3 * (cin // 64) <= resident
    assert len(wgrad_variants.chunk_extents(b, h, w, th, tiles, segs)) == parts


def test_xcol_gtcol_plan_splits_row_tiles_along_w():
    """Too few row tiles for a wave: the plan splits them along W, and at
    the sweep's shapes no th takes more than a tenth more steps a chunk than
    the other."""
    chunks, tiles, segs = wgrad_variants.xcol_gtcol_plan(1, 8, 468, 64, 64, 8, 264)
    assert (tiles, segs) == (1, 1) and chunks == 8
    for cin in (64, 128):
        steps = [tiles * th * segs for th in (8, 16) for _, tiles, segs in
                 [wgrad_variants.xcol_gtcol_plan(2, 468, 468, cin, 64, th, 264)]]
        assert max(steps) <= 1.1 * min(steps)


@pytest.mark.parametrize("variant", VARIANTS)
def test_xcol_gtcol_chunked_sum_matches_jax(interpret, variant):
    """The kernels' arithmetic in plain PyTorch: one f32 partial for each
    chunk of the plan (the pixels of the operand the kernel reads in place,
    x for T1 and g for the others; row tiles split along W here), the
    partials added in chunk order; against the JAX kernel."""
    b, h, w, cin, cout, th = 2, 11, 70, 8, 16, 4
    xj, gj, xt, gt = _inputs(7, b, h, w, cin, cout)
    chunks, tiles, segs = wgrad_variants.xcol_gtcol_plan(b, h, w, cin, cout, th, 36)
    assert segs < -(-w // wgrad_variants.SEGMENT) and chunks > 2
    plain = wgrad_variants.VARIANTS[variant][1]
    dw = torch.zeros((3, 3, cin, cout))
    for r0, r1, s0, s1 in wgrad_variants.chunk_extents(b, h, w, th, tiles, segs):
        mask = torch.zeros((b * h, w))
        mask[r0:r1, s0 * 64:s1 * 64] = 1
        mask = mask.reshape(b, h, w, 1).to(gt.dtype)
        if variant == "gcol":
            dw = dw + plain(xt * mask, gt, th)
        else:
            dw = dw + plain(xt, gt * mask, th)
    want = np.asarray(getattr(mb, f"wgrad_{variant}")(xj, gj, th))
    tol = 1e-5 * wgrad_variants.oracle(xt.float().abs(), gt.float().abs()).numpy()
    assert (np.abs(dw.numpy() - want) <= tol).all()


def test_plain_versions_take_any_float_dtype():
    _, _, xt, gt = _inputs(3, 1, 11, 7, 5, 3)
    ref = wgrad_variants.oracle(xt, gt)
    for variant in VARIANTS:
        plain = wgrad_variants.VARIANTS[variant][1]
        for dt in (torch.float32, torch.float64):
            out = plain(xt.to(dt), gt.to(dt), 4)
            assert out.dtype == torch.float32
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_sweep_run_on_cpu_launches_nothing():
    counters = [*(f"{v}_launches" for v in VARIANTS)]
    before = [getattr(wgrad_variants, c) for c in counters] + [conv2d.wgrad_launches]
    rows = port_mb.run(shapes=((1, 13, 9, 8, 16),), ths=(8,), variants=("v0", *VARIANTS),
                       iters=3, device="cpu")
    after = [getattr(wgrad_variants, c) for c in counters] + [conv2d.wgrad_launches]
    assert after == before
    assert [r["name"] for r in rows] == ["v0 current", *(f"{v} th=8" for v in VARIANTS)]
    for r in rows:
        assert r["ok"] and r["err"] <= 1e-5 and r["calls"] == 1
        assert r["ms"] is None and r["tflops"] is None


def test_wrappers_take_the_cpu_path_only_for_cpu_tensors():
    x = torch.zeros((1, 4, 4, 2), device="meta", dtype=torch.bfloat16)
    for variant in VARIANTS:
        with pytest.raises(ValueError, match="unsupported device meta"):
            wgrad_variants.VARIANTS[variant][0](x, x, 8)
