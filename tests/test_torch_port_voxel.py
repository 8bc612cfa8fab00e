"""The port's sparse conv engine (``com_tpu_torch/ops/sparse.py``) against
the JAX package's default engine (``com_tpu/ops/sparse.py``) on the CPU.

Inputs are numpy from a seed: random sites in small grids with padded
invalid rows (coords -1), as ``tests/test_sparse_engine_ab.py`` builds them.
Rulebooks, downsampled sites and their coords must be equal exactly, through
the dense table and through the sorted search; conv outputs and gradients
agree to 1e-4 with ``jax.vjp`` of the default engine, and the JAX v1 engine
(the 27-tap loop, reached through its ``COM_TPU_SPARSE`` switch) is held to
the same numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.ops import sparse as js
from com_tpu_torch.ops import sparse as ps
from tests.test_sparse_conv import random_sparse

torch.set_num_threads(2)
ATOL = 1e-4
# (stride, kernel, pad, out_cap): stage 2-3's conv, the cap overflowing,
# conv4's z-pad 0, conv_out's anisotropic (3, 1, 1) / (2, 1, 1)
STRIDED = [((2, 2, 2), 3, 1, 70), ((2, 2, 2), 3, 1, 20), ((2, 2, 2), 3, (0, 1, 1), 60),
           ((2, 1, 1), (3, 1, 1), 0, 60)]


def scene(seed, grid=(5, 9, 9), n=60, cin=6, pad=12):
    """(features, coords, valid) numpy: ``n`` distinct sites then ``pad``
    invalid rows with random features."""
    rng = np.random.RandomState(seed)
    coords, feats = random_sparse(rng, grid, n, cin)
    coords = np.concatenate([coords, np.full((pad, 3), -1, np.int32)])
    feats = np.concatenate([feats, rng.randn(pad, cin).astype(np.float32)])
    return feats, coords, np.arange(n + pad) < n


@pytest.fixture(params=["dense", "sorted"])
def lookup(request, monkeypatch):
    """Both lookup structures on both sides: the port's by its cell cap,
    the JAX engine's by its switch."""
    monkeypatch.setenv("COM_TPU_SPARSE_LOOKUP", request.param)
    monkeypatch.setattr(ps, "DENSE_CELL_CAP", 10**12 if request.param == "dense" else 0)
    return request.param


def t(a):
    return torch.from_numpy(np.array(a))


def test_subm_rulebook_equal(lookup):
    for seed, grid in ((3, (5, 9, 9)), (7, (6, 11, 11))):
        _, c, v = scene(seed, grid, n=80, cin=3)
        want = np.asarray(js.subm_rulebook(jnp.asarray(c), jnp.asarray(v), grid))
        got = ps.subm_rulebook(t(c), t(v), grid).numpy()
        np.testing.assert_array_equal(got, want)
        # every site finds itself at the centre tap
        np.testing.assert_array_equal(got[13][v], np.nonzero(v)[0])


@pytest.mark.parametrize("stride,kernel,pad,cap", STRIDED)
def test_downsample_sites_and_strided_rulebook_equal(lookup, stride, kernel, pad, cap):
    grid = (7, 10, 10)
    _, c, v = scene(4, grid, n=50, cin=4)
    jc, jv, jg = js.downsample_sites(jnp.asarray(c), jnp.asarray(v), stride, cap, grid,
                                     kernel=kernel, pad=pad)
    pc, pv, pg = ps.downsample_sites(t(c), t(v), stride, cap, grid, kernel=kernel, pad=pad)
    assert pg == jg == ps.downsampled_grid(grid, stride, kernel, pad)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    want = js._strided_rulebook_outprobe(jnp.asarray(c), jnp.asarray(v), jc, jv, jg, stride,
                                         ps._triple(kernel), ps._triple(pad))
    got = ps.strided_rulebook(t(c), t(v), grid, cap, stride, kernel, pad)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_downsample_overflow_drops_in_key_order():
    """Past the cap the largest keys go: the capped sites are the first
    ``cap`` of the uncapped ones, and the odd-coordinate halo is there."""
    grid = (5, 10, 10)
    _, c, v = scene(9, grid, n=50, cin=1)
    full_c, full_v, _ = ps.downsample_sites(t(c), t(v), 2, 400, grid)
    n = int(full_v.sum())
    cap_c, cap_v, _ = ps.downsample_sites(t(c), t(v), 2, 20, grid)
    assert n > 20 and int(cap_v.sum()) == 20
    np.testing.assert_array_equal(cap_c.numpy(), full_c[:20].numpy())
    # an odd input coordinate reaches two outputs along its axis
    inner = (c[:, 2] < 9) & (c[:, 1] < 9) & (c[:, 0] < 4)
    odd = np.nonzero(v & inner & (c[:, 2] % 2 == 1))[0][0]
    sites = {tuple(x) for x in full_c[full_v].numpy()}
    for ox in ((c[odd, 2] + 1) // 2, (c[odd, 2] + 1) // 2 - 1):
        assert ((c[odd, 0] + 1) // 2, (c[odd, 1] + 1) // 2, ox) in sites


def test_scatter_to_dense_equal():
    grid = (3, 6, 7)
    f, c, v = scene(5, grid, n=30, cin=4)
    want = js.scatter_to_dense(jnp.asarray(f), jnp.asarray(c), jnp.asarray(v), grid)
    got = ps.scatter_to_dense(t(f), t(c), t(v), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grads_jax(fn, f, w):
    out, vjp = jax.vjp(fn, jnp.asarray(f), jnp.asarray(w))
    g = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    return np.asarray(out), g, [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _grads_port(fn, f, w, g):
    ft, wt = t(f).requires_grad_(), t(w).requires_grad_()
    out = fn(ft, wt)
    out.backward(t(g))
    return out.detach().numpy(), [ft.grad.numpy(), wt.grad.numpy()]


def _check(got, want, what):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL, err_msg=what)


@pytest.mark.parametrize("engine", ["v2", "v1"])
def test_subm_conv_forward_backward(lookup, monkeypatch, engine):
    """Forward and the gather-only (mirror) backward against jax.vjp of the
    JAX engine: its default v2 and its v1 oracle."""
    monkeypatch.setenv("COM_TPU_SPARSE", engine)
    grid = (5, 9, 9)
    f, c, v = scene(11, grid, n=55, cin=6)
    w = np.random.RandomState(2).randn(27, 6, 8).astype(np.float32) * 0.3
    jout, g, jgrads = _grads_jax(
        lambda ff, ww: js.submanifold_conv3d(ff, jnp.asarray(c), jnp.asarray(v), ww, grid), f, w)
    out, grads = _grads_port(
        lambda ff, ww: ps.submanifold_conv3d(ff, t(c), t(v), ww, grid), f, w, g)
    _check(out, jout, "forward")
    _check(grads[0], jgrads[0], "dfeatures")
    _check(grads[1], jgrads[1], "dweights")
    assert not grads[0][~v].any()  # invalid rows take no gradient


@pytest.mark.parametrize("stride,kernel,pad,cap", STRIDED[:2] + STRIDED[3:])
def test_strided_conv_forward_backward(lookup, stride, kernel, pad, cap):
    grid = (7, 10, 10)
    f, c, v = scene(12, grid, n=50, cin=4)
    k3 = int(np.prod(ps._triple(kernel)))
    w = np.random.RandomState(3).randn(k3, 4, 6).astype(np.float32) * 0.3

    def jfn(ff, ww):
        return js.strided_conv3d(ff, jnp.asarray(c), jnp.asarray(v), ww, grid, cap, stride,
                                 kernel, pad)[0]

    jout, g, jgrads = _grads_jax(jfn, f, w)
    out, grads = _grads_port(
        lambda ff, ww: ps.strided_conv3d(ff, t(c), t(v), ww, grid, cap, stride, kernel, pad)[0],
        f, w, g)
    _check(out, jout, "forward")
    _check(grads[0], jgrads[0], "dfeatures")
    _check(grads[1], jgrads[1], "dweights")


def test_batched_convs_equal_per_scene():
    """The batch helpers (rulebooks a scene, one stacked gather and product)
    give each scene's own conv, forward and backward."""
    grid = (5, 9, 9)
    scenes = [scene(s, grid, n=n, cin=5, pad=72 - n) for s, n in ((20, 60), (21, 35))]
    f = t(np.stack([s[0] for s in scenes]))
    c, v = t(np.stack([s[1] for s in scenes])), t(np.stack([s[2] for s in scenes]))
    w = t(np.random.RandomState(4).randn(27, 5, 7).astype(np.float32) * 0.3)
    fb, wb = f.clone().requires_grad_(), w.clone().requires_grad_()
    nidx = ps.batched_subm_rulebook(c, v, grid)
    snidx, back, oc, ov, og = ps.batched_strided_rulebook(c, v, grid, 40, 2)
    out = ps.batched_subm_conv3d(fb, v, nidx, wb)
    sout = ps.batched_gather_conv3d(fb, v, snidx, back, ov, wb)
    (out.sum() + (sout * sout).sum()).backward()
    for i in range(2):
        fi, wi = f[i].clone().requires_grad_(), w.clone().requires_grad_()
        o = ps.submanifold_conv3d(fi, c[i], v[i], wi, grid)
        so, soc, sov, sog = ps.strided_conv3d(fi, c[i], v[i], wi, grid, 40, 2)
        (o.sum() + (so * so).sum()).backward()
        assert sog == og
        np.testing.assert_array_equal(soc.numpy(), oc[i].numpy())
        np.testing.assert_array_equal(sov.numpy(), ov[i].numpy())
        _check(out[i].detach().numpy(), o.detach().numpy(), "subm")
        _check(sout[i].detach().numpy(), so.detach().numpy(), "strided")
        _check(fb.grad[i].numpy(), fi.grad.numpy(), "dfeatures")
        wi_grad = wi.grad.numpy() if i == 0 else wi_grad + wi.grad.numpy()
    _check(wb.grad.numpy(), wi_grad, "dweights")


def test_dense_and_sorted_lookups_agree(monkeypatch):
    """The two lookup structures give one rulebook."""
    assert ps.use_dense_lookup((41, 1498, 1498))  # the Waymo voxel grid: 92.0M cells
    assert not ps.use_dense_lookup((41, 1600, 1600))
    grid = (6, 11, 11)
    _, c, v = scene(13, grid, n=90, cin=1)
    books = []
    for cap in (10**12, 0):
        monkeypatch.setattr(ps, "DENSE_CELL_CAP", cap)
        books.append(ps.subm_rulebook(t(c), t(v), grid).numpy())
        books.append(ps.strided_rulebook(t(c), t(v), grid, 100, 2)[0].numpy())
    np.testing.assert_array_equal(books[0], books[2])
    np.testing.assert_array_equal(books[1], books[3])


@pytest.mark.parametrize("name", ["inverse_conv3d", "focal_split_and_spawn"])
def test_unported_engine_functions_raise_by_name(name):
    """Both engine functions, which raised by name until ported, run (held
    to the JAX engine in ``test_torch_port_parta2.py`` and
    ``test_torch_port_image_models.py``): a centre-tap inverse of a
    stride-2 conv gives each even high-resolution site its low-resolution
    row; a foreground voxel with one confident offset spawns that neighbour
    (its features times the score), the rest of the cap invalid."""
    if name == "inverse_conv3d":
        c = torch.tensor([[0, 0, 0], [2, 2, 4], [3, 1, 1], [4, 6, 2]])
        valid = torch.ones(4, dtype=torch.bool)
        oc, ov = torch.tensor([[0, 0, 0], [1, 1, 2], [2, 3, 1]]), torch.ones(3, dtype=torch.bool)
        w = torch.zeros(27, 2, 2)
        w[13] = torch.eye(2)
        feats = torch.arange(6.0).reshape(3, 2)
        out = ps.inverse_conv3d(feats, oc, ov, w, c, valid, (4, 4, 4))
        assert torch.equal(out, torch.stack([feats[0], feats[1], torch.zeros(2), feats[2]]))
        return
    coords = torch.tensor([[[1, 1, 1], [-1, -1, -1]]])
    imps = torch.full((1, 2, 27), -9.0)
    imps[0, 0, 26] = imps[0, 0, 25] = 9.0  # its own and its last offset, (+1, +1, +1)
    feats = torch.ones(1, 2, 3)
    out, oc, ov, own = ps.focal_split_and_spawn(feats, coords, torch.tensor([[True, False]]),
                                                imps, (4, 4, 4), 0.5, 3)
    assert ov.tolist() == [[True, False, True, False, False]]
    assert oc[0, 2].tolist() == [2, 2, 2] and (oc[0, 3:] == -1).all()
    torch.testing.assert_close(out[0, 2], torch.full((3,), float(torch.sigmoid(torch.tensor(9.0)))))
