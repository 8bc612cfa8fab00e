"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without a CUDA device every test skips (decided in the
fixture).  On the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q

Shapes are small but ragged (tiles cut, runs crossing tile edges, whole-
sample runs).  Max, keep masks and launch counts are exact; f32 sums and
convs are held to f32 rounding, bf16 convs to one bf16 rounding.
"""
import numpy as np
import pytest
import torch

from com_tpu_torch.ops import conv2d, nms, seg_scan

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


@pytest.mark.parametrize("k", [1, 64, 500, 700])
def test_greedy_suppress_kernel(dev, k):
    rng = np.random.RandomState(k)
    over = torch.from_numpy(rng.rand(2, k, k) < 0.02).to(dev)
    valid = torch.from_numpy(rng.rand(2, k) < 0.9).to(dev)
    before = nms.launches
    got = nms.greedy_suppress(over, valid)
    torch.cuda.synchronize()
    assert nms.launches == before + 1
    assert torch.equal(got, nms.greedy_suppress_plain(over, valid))


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
        nms.greedy_suppress(torch.zeros((1, 3, 3), device=dev), torch.ones((1, 3), device=dev,
                                                                          dtype=torch.bool))


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
