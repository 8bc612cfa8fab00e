"""The training slice's kernel ops and norms against the JAX package, on the
CPU.

Same numpy-seeded inputs into both.  JAX runs as its own tests run it: K3
through the XLA scatter path (and the Pallas kernel in interpret mode for
the preprocessing), K1 through its Pallas kernel in interpret mode (the
XLA reference sums bf16 in bf16, the kernel in f32 as the port does), K2
through ``lax.conv``, gradients by ``jax.grad``.  The port runs its plain versions on CPU tensors,
through the same ``autograd.Function``s that launch the kernels on the card.
Tolerances: gaussians 2e-6 (the analytic f32 exp against the f64-built
table, as ``tests/test_stamp_pallas.py``); last-wins stamps, ids and masks
exact; f32 gradients 1e-5 relative (sums taken in another order), conv
gradients atol 1e-4; bf16 run-sum gradients 2^-7 of the run's sum of |g|
(bf16 roundings of partial sums).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from com_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from com_tpu.ops import gaussian as jax_gaussian
from com_tpu.ops.pallas import stamp as jax_stamp
from com_tpu.ops.pallas.conv2d import _conv3x3_wgrad_pallas
from com_tpu.ops.pallas.conv2d import conv3x3 as jax_conv3x3
from com_tpu.ops.pallas.seg_scan import run_bcast as jax_run_bcast
from com_tpu_torch.models.layers import BatchNorm, MaskedBatchNorm
from com_tpu_torch.ops import conv2d, gaussian, seg_scan, stamp

torch.set_num_threads(2)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _objects(rng, b, n, c, h, w, rmax):
    """Objects with some invalid, some radii past the clip, many overlaps."""
    centers = np.stack([rng.randint(0, w, (b, n)), rng.randint(0, h, (b, n))], -1)
    radii = rng.randint(0, rmax + 4, (b, n))
    cls = rng.randint(0, c, (b, n))
    values = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    valid = rng.rand(b, n) > 0.3
    return (centers.astype(np.int32), radii.astype(np.int32), cls.astype(np.int32), values,
            valid)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_gaussian_radius_matches_jax():
    rng = _rng("radius")
    h = rng.uniform(0.5, 60.0, 500).astype(np.float32)
    w = rng.uniform(0.5, 60.0, 500).astype(np.float32)
    for overlap in (0.1, 0.5, 0.7):
        want = np.asarray(jax_gaussian.gaussian_radius(jnp.asarray(h), jnp.asarray(w), overlap))
        got = gaussian.gaussian_radius(*_t(h, w), min_overlap=overlap).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gaussian._gaussian_table(16), jax_gaussian._gaussian_table(16))


@pytest.mark.parametrize("rmax", [6, 16])
def test_draw_gaussians_batched_matches_jax(rmax):
    rng = _rng("gauss", rmax)
    b, n, c, h, w = 2, 40, 3, 70, 52
    centers, radii, cls, _, valid = _objects(rng, b, n, c, h, w, rmax)
    want = np.asarray(jax_gaussian.draw_gaussians_batched(
        *(jnp.asarray(a) for a in (centers, radii, cls, valid)), c, h, w, rmax))
    got = gaussian.draw_gaussians_batched(*_t(centers, radii, cls, valid), c, h, w, rmax)
    assert got.dtype == torch.float32 and got.shape == (b, c, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # every valid center reads exactly 1.0 (the focal loss tests equality)
    bi, oi = np.nonzero(valid)
    assert (got.numpy()[bi, cls[bi, oi], centers[bi, oi, 1], centers[bi, oi, 0]] == 1.0).all()


def test_stamp_squares_batched_matches_jax():
    rng = _rng("squares")
    b, n, c, h, w, rmax = 2, 30, 2, 64, 48, 16
    centers, radii, cls, values, valid = _objects(rng, b, n, c, h, w, rmax)
    want = np.asarray(jax_gaussian.stamp_squares_batched(
        *(jnp.asarray(a) for a in (centers, radii, cls, values, valid)), c, h, w, fill=1.0,
        max_radius=rmax))
    got = gaussian.stamp_squares_batched(*_t(centers, radii, cls, values, valid), c, h, w,
                                         fill=1.0, max_radius=rmax)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["gauss", "last_wins"])
def test_stamp_windows_preprocessing_matches_pallas(mode):
    """Garbage in the padded slots (centers off the map, classes out of
    range, negative radii): the plain route clamps as ``_stamp_pallas``
    does, and agrees with the Pallas kernel in interpret mode."""
    rng = _rng("pre", mode)
    b, n, c, h, w, rmax = 2, 12, 3, 24, 40, 5
    centers, radii, cls, values, valid = _objects(rng, b, n, c, h, w, rmax)
    centers[:, :3] = [[-7, 3], [w + 9, -2], [5, h + 30]]
    cls[:, 3] = c + 2
    radii[:, 4] = -3
    fill = 0.0 if mode == "gauss" else 1.0
    want = np.asarray(jax_stamp.stamp_windows(
        *(jnp.asarray(a) for a in (centers, radii, cls, values, valid)), c, h, w, mode,
        fill=fill, max_radius=rmax, interpret=True))
    got = stamp.stamp_windows(*_t(centers, radii, cls, values, valid), c, h, w, mode,
                              fill=fill, max_radius=rmax).numpy()
    if mode == "gauss":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["gauss", "last_wins"])
def test_stamp_windows_crowded_and_edges_match_pallas(mode):
    """Many windows on one cell (twelve objects on one center, radii 0 to
    the clip) and windows across each canvas edge and corner: the plain
    route against the Pallas kernel in interpret mode."""
    rng = _rng("crowd", mode)
    b, n, c, h, w, rmax = 2, 40, 2, 20, 28, 6
    centers, radii, cls, values, valid = _objects(rng, b, n, c, h, w, rmax)
    centers[:, :12] = [9, 7]
    cls[:, :12] = 1
    radii[:, :12] = np.arange(12) % (rmax + 2)
    valid[:, :12] = True
    centers[:, 12:20] = [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [1, 10], [w - 2, 10],
                         [14, 1], [14, h - 2]]
    radii[:, 12:20] = rmax
    valid[:, 12:20] = True
    fill = 0.0 if mode == "gauss" else 1.0
    want = np.asarray(jax_stamp.stamp_windows(
        *(jnp.asarray(a) for a in (centers, radii, cls, values, valid)), c, h, w, mode,
        fill=fill, max_radius=rmax, interpret=True))
    got = stamp.stamp_windows(*_t(centers, radii, cls, values, valid), c, h, w, mode,
                              fill=fill, max_radius=rmax).numpy()
    if mode == "gauss":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
        assert got[0, 1, 7, 9] == 1.0
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fill", [-0.5, 0.25])
def test_stamp_windows_gauss_fill_matches_pallas(fill):
    """Gauss over a negative and a positive fill: only each object's
    (2r+1)^2 window is stamped, as in the Pallas kernel (interpret mode),
    so a negative fill stays outside the windows."""
    rng = _rng("gfill", fill)
    b, n, c, h, w, rmax = 2, 10, 2, 20, 24, 6
    centers, radii, cls, values, valid = _objects(rng, b, n, c, h, w, rmax)
    want = np.asarray(jax_stamp.stamp_windows(
        *(jnp.asarray(a) for a in (centers, radii, cls, values, valid)), c, h, w, "gauss",
        fill=fill, max_radius=rmax, interpret=True))
    got = stamp.stamp_windows(*_t(centers, radii, cls, values, valid), c, h, w, "gauss",
                              fill=fill, max_radius=rmax).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert got.min() == fill


def _run_bcast_case(op, dtype, key):
    rng = _rng("rbg", op, key)
    b, n, c = 2, 700, 16
    seg = np.sort(rng.randint(0, 60, (b, n)), axis=1).astype(np.int32)
    # coarse values so that runs hold tied maxima
    vals = (np.round(rng.randn(b, n, c) * 2) / 2).astype(np.float32)
    cot = rng.randn(b, n, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jv, jc = jnp.asarray(vals).astype(jdt), jnp.asarray(cot).astype(jdt)

    def f(v):
        return (jax_run_bcast(v, jnp.asarray(seg), op, "interpret").astype(jnp.float32)
                * jc.astype(jnp.float32)).sum()

    want = np.asarray(jax.grad(f)(jv).astype(jnp.float32))
    tv = torch.from_numpy(vals).to(dtype).requires_grad_()
    out = seg_scan.run_bcast(tv, torch.from_numpy(seg), op)
    out.backward(torch.from_numpy(cot).to(dtype))
    # the run's sum of |g|: every partial sum either side rounds is below it
    scale = seg_scan.run_bcast_plain(torch.from_numpy(cot).to(dtype).float().abs(),
                                     torch.from_numpy(seg), "sum").numpy()
    return tv.grad.float().numpy(), want, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_bcast_grad_matches_jax(op, dtype):
    got, want, scale = _run_bcast_case(op, dtype, str(dtype))
    if op == "max":
        assert (want != 0).sum() > 0 and ((want != 0) & (np.abs(want) < np.abs(want).max())).any()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # the JAX kernel rounds its running prefix to bf16 and the port
        # rounds the f32 total once: a few bf16 roundings of partial sums,
        # each below 2^-9 of the run's sum of |g|
        assert (np.abs(got - want) <= 2.0 ** -7 * scale + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["pillars", "whole_sample"])
def test_run_bcast_max_bwd_plain_matches_jax(dtype, layout):
    """The fused max backward's plain version (what ``k1_call`` op 2 computes)
    against ``jax.grad`` of the JAX ``run_bcast`` (Pallas, interpret mode),
    on runs with tied maxima and on one run over a whole sample."""
    rng = _rng("mbwd", layout, str(dtype))
    b, n, c = 2, 600, 8
    seg = np.sort(rng.randint(0, 50, (b, n)), axis=1).astype(np.int32)
    if layout == "whole_sample":
        seg[1] = 7
    vals = (np.round(rng.randn(b, n, c) * 2) / 2).astype(np.float32)
    g = rng.randn(b, n, c).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jv, jg = jnp.asarray(vals).astype(jdt), jnp.asarray(g).astype(jdt)
    want = np.asarray(jax.vjp(lambda v: jax_run_bcast(v, jnp.asarray(seg), "max", "interpret"),
                              jv)[1](jg)[0].astype(jnp.float32))
    tv, tg = torch.from_numpy(vals).to(dtype), torch.from_numpy(g).to(dtype)
    ts = torch.from_numpy(seg)
    out = seg_scan.run_bcast_plain(tv, ts, "max")
    got = seg_scan.run_bcast_max_bwd_plain(tg, tv, out, ts)
    assert got.dtype == dtype and got.shape == (b, n, c)
    assert (want != 0).sum() < want.size // 2  # the gradient goes to the maxima only
    scale = seg_scan.run_bcast_plain(tg.float().abs(), ts, "sum").numpy()
    assert (np.abs(got.float().numpy() - want) <= 2.0 ** -7 * scale + 1e-6).all()


def test_run_bcast_max_grad_splits_ties_evenly():
    vals = torch.tensor([[[1.0], [3.0], [3.0], [2.0], [3.0], [5.0]]], requires_grad=True)
    seg = torch.tensor([[0, 0, 0, 0, 0, 1]], dtype=torch.int32)
    seg_scan.run_bcast(vals, seg, "max").sum().backward()
    # run 0: five rows of gradient 1 split over its three maxima
    np.testing.assert_allclose(vals.grad[0, :, 0].numpy(), [0, 5 / 3, 5 / 3, 0, 5 / 3, 1],
                               rtol=1e-6)


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 20, 13, 8, 16), (1, 9, 17, 16, 5)])
def test_conv3x3_grads_match_jax(b, h, w, cin, cout):
    rng = _rng("cvg", b, h, w, cin, cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    cot = rng.randn(b, h, w, cout).astype(np.float32)

    def f(xx, kk):
        return (jax_conv3x3(xx, kk) * jnp.asarray(cot)).sum()

    jdx, jdw = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k)))
    tx, tk = (t.requires_grad_() for t in _t(x, k))
    conv2d.conv3x3(tx, tk).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tx.grad.numpy(), jdx, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tk.grad.numpy(), jdw, atol=1e-4, rtol=0)


def test_conv3x3_wgrad_plain_matches_the_pallas_kernel():
    """``conv3x3_wgrad_plain`` against K2w's own TPU kernel (interpret mode)."""
    rng = _rng("wg")
    x = rng.randn(2, 16, 12, 8).astype(np.float32)
    g = rng.randn(2, 16, 12, 8).astype(np.float32)
    want = np.asarray(_conv3x3_wgrad_pallas(jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = conv2d.conv3x3_wgrad(*_t(x, g))
    assert got.shape == (3, 3, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_conv3x3_grad_dtypes_under_mixed_precision():
    """bf16 x and w: dx in bf16, dw rounded to bf16 before the f32 master
    weight sees it (``conv2d.py:555``)."""
    rng = _rng("mp")
    master = torch.from_numpy((rng.randn(4, 3, 3, 3) * 0.2).astype(np.float32)).requires_grad_()
    x = torch.from_numpy(rng.randn(1, 6, 7, 3).astype(np.float32)).to(torch.bfloat16)
    x.requires_grad_()
    w = master.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
    y = conv2d.conv3x3(x, w)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and master.grad.dtype == torch.float32
    dw = conv2d.conv3x3_wgrad_plain(x.detach(), torch.ones_like(y)).to(torch.bfloat16).float()
    np.testing.assert_array_equal(master.grad.numpy(), dw.permute(3, 2, 0, 1).numpy())


def _flax_bn(x, mask, variables, masked, eps):
    if masked:
        mod = JaxMaskedBatchNorm(epsilon=eps)
        return mod.apply(variables, jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask),
                         use_running_average=False, mutable=["batch_stats"])
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=eps)
    return mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])


@pytest.mark.parametrize("masked", [False, True])
def test_batch_norm_training_matches_flax(masked):
    """Output, input and parameter gradients, and the running statistics
    after one training call, against flax (``nn.BatchNorm`` for the
    backbone/head norms, the JAX package's ``MaskedBatchNorm`` for the PFN)."""
    rng = _rng("bn", masked)
    c, eps = 6, 1e-3
    x = (rng.randn(2, 50, c) * 3 + 1).astype(np.float32)
    mask = rng.rand(2, 50) > 0.3 if masked else None
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    cot = rng.randn(2, 50, c).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    y, mut = _flax_bn(x, mask, variables, masked, eps)

    def f(xx, params):
        out, _ = _flax_bn(xx, mask, {**variables, "params": params}, masked, eps)
        return (out * jnp.asarray(cot)).sum()

    jdx, jdp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), variables["params"])

    bn = (MaskedBatchNorm if masked else BatchNorm)(c, eps=eps).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x).requires_grad_()
    out = bn(tx, torch.from_numpy(mask)) if masked else bn(tx)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jdp["scale"]), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdp["bias"]), atol=1e-4, rtol=1e-5)
    if masked:  # padded rows still get normalised outputs but no say in the statistics
        x2 = x.copy()
        x2[~mask] = 1e3
        bn2 = MaskedBatchNorm(c, eps=eps).train()
        np.testing.assert_allclose(bn2(torch.from_numpy(x2), torch.from_numpy(mask))[mask]
                                   .detach().numpy(),
                                   MaskedBatchNorm(c, eps=eps).train()(
                                       torch.from_numpy(x), torch.from_numpy(mask))[mask]
                                   .detach().numpy(), atol=1e-5)


def test_batch_norm_eval_uses_running_statistics():
    bn = BatchNorm(3).eval()
    with torch.no_grad():
        bn.running_mean.fill_(1.0)
        bn.running_var.fill_(4.0)
    x = torch.full((5, 3), 3.0)
    np.testing.assert_allclose(bn(x).detach().numpy(), np.full((5, 3), 2.0 / np.sqrt(4.0 + 1e-3)),
                               rtol=1e-6)
    assert int(bn.num_batches_tracked) == 0
