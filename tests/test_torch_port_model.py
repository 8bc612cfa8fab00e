"""The port's model modules against the JAX package's, on the CPU.

One flagship-config detector at a 32x32 grid, batch 2, 2048 presorted points
a scene, f32 on both sides, JAX weights perturbed from a seed and carried
over by the port's weight bridge.  Each module is fed the JAX module's own
input, so an error is charged to the module that made it.  f32 atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import __graft_entry__ as graft
from com_tpu.models import layers as jax_layers
from com_tpu.models.dense_heads.center_head import decode_center_boxes as jax_decode
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu_torch.models import layers
from com_tpu_torch.models.dense_heads.center_head import decode_center_boxes
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops import conv2d
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb

torch.set_num_threads(2)
ATOL = 1e-4
BRANCHES = ("center", "center_z", "dim", "rot", "hm")


def _port_net(cfg, meta, variables):
    pmeta = DatasetMeta(meta.class_names, meta.point_cloud_range, meta.voxel_size,
                        meta.grid_size, meta.num_point_features)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    return load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))


@pytest.fixture(scope="module")
def model_setup():
    cfg, meta, _, batch = graft._build(batch_size=2, num_points=2048, grid=(32, 32, 1))
    cfg.MODEL.MIXED_PRECISION = False
    jnet = jax_build_network(cfg.MODEL, meta)
    host = {"points": np.array(batch["points"]), "points_mask": np.array(batch["points_mask"])}
    host["points_mask"][1, -300:] = False  # a padded tail in sample 1
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), host, train=False)
    variables = perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=2)
    ref = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(variables, host)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return cfg, meta, variables, _port_net(cfg, meta, variables), host, ref


def _t(a):
    return torch.from_numpy(np.array(a))


def test_vfe_matches_jax(model_setup):
    _, _, _, net, host, ref = model_setup
    with torch.no_grad():
        out = net.vfe({k: _t(v) for k, v in host.items()})
    got = out["spatial_features"]
    assert tuple(got.shape) == ref["spatial_features"].shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got.numpy(), ref["spatial_features"], atol=ATOL, rtol=0)


def test_vfe_device_sort_matches_jax(model_setup):
    """Unsorted points (ASSUME_SORTED_POINTS off): the port sorts on the
    device with torch.sort, the JAX package with lax.sort."""
    cfg, meta, variables, _, host, _ = model_setup
    cfg = cfg.clone()
    cfg.MODEL.VFE["ASSUME_SORTED_POINTS"] = False
    perm = np.random.RandomState(3).permutation(host["points"].shape[1])
    shuffled = {k: v[:, perm] for k, v in host.items()}
    jnet = jax_build_network(cfg.MODEL, meta)
    want = np.asarray(jnet.apply(variables, dict(shuffled), train=False)["spatial_features"])
    net = _port_net(cfg, meta, variables)
    with torch.no_grad():
        got = net.vfe({k: _t(v) for k, v in shuffled.items()})["spatial_features"]
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_backbone_matches_jax(model_setup):
    _, _, _, net, _, ref = model_setup
    with torch.no_grad():
        out = net.backbone_2d({"spatial_features": _t(ref["spatial_features"])})
    got = out["spatial_features_2d"]
    assert tuple(got.shape) == (2, 32, 32, 384)
    np.testing.assert_allclose(got.numpy(), ref["spatial_features_2d"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("branch", BRANCHES)
def test_center_head_branch_matches_jax(model_setup, branch):
    _, _, _, net, _, ref = model_setup
    with torch.no_grad():
        out = net.dense_head({"spatial_features_2d": _t(ref["spatial_features_2d"])})
    got = out["pred_dicts"][0][branch]
    want = ref["pred_dicts"][0][branch]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_decode_center_boxes_matches_jax():
    rng = np.random.RandomState(4)
    b, h, w = 2, 20, 24
    pred = {"hm": rng.randn(b, h, w, 3).astype(np.float32),
            "center": rng.rand(b, h, w, 2).astype(np.float32),
            "center_z": rng.randn(b, h, w, 1).astype(np.float32),
            "dim": rng.randn(b, h, w, 3).astype(np.float32),
            "rot": rng.randn(b, h, w, 2).astype(np.float32)}
    pred["hm"][0, :4, :4, 1] = 1.5  # exact score ties: the lower flat index first
    kw = dict(class_ids=(1, 2, 3), point_cloud_range=(-3.2, -3.84, -2.0, 3.2, 3.84, 4.0),
              voxel_size=(0.32, 0.32, 6.0), feature_map_stride=1, k=300, score_thresh=0.3,
              post_center_limit_range=(-3.0, -3.0, -10.0, 3.0, 3.0, 10.0))
    want = [np.asarray(v) for v in jax_decode({k: jnp.asarray(v) for k, v in pred.items()},
                                              **kw)]
    got = [t.numpy() for t in decode_center_boxes({k: _t(v) for k, v in pred.items()}, **kw)]
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert want[3].sum() > 10


def test_masked_batch_norm_eval_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 40, 16).astype(np.float32)
    mask = rng.rand(2, 40) < 0.7
    mod = jax_layers.MaskedBatchNorm()
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask=jnp.asarray(mask),
                 use_running_average=True)
    v = perturb(jax.tree_util.tree_map(np.asarray, dict(v)), seed=6)
    want = np.asarray(mod.apply(v, jnp.asarray(x), mask=jnp.asarray(mask),
                                use_running_average=True))
    bn = layers.MaskedBatchNorm(16, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(_t(v["params"]["scale"]))
        bn.bias.copy_(_t(v["params"]["bias"]))
        bn.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(v["batch_stats"]["var"]))
        got = bn(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # training mode normalises with the masked rows' own statistics (held
    # against flax in tests/test_torch_port_train_ops.py): their mean comes
    # out as the bias
    with torch.no_grad():
        out = bn.train()(_t(x), _t(mask))
    np.testing.assert_allclose(out.numpy()[mask].mean(0), bn.bias.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("stride,size", [(2, 10), (2, 9), (1, 7)])
def test_conv_bn_relu_padding_matches_jax(stride, size):
    """Strided convs pad (1, 1) symmetrically like pcdet, not SAME."""
    rng = np.random.RandomState(stride * 100 + size)
    x = rng.randn(1, size, size, 4).astype(np.float32)
    mod = jax_layers.ConvBNReLU(6, kernel=3, stride=stride, pallas=False)
    v = mod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    v = perturb(jax.tree_util.tree_map(np.asarray, dict(v)), seed=7)
    want = np.asarray(mod.apply(v, jnp.asarray(x), train=False))
    port = layers.ConvBNReLU(4, 6, 3, stride).eval()
    with torch.no_grad():
        port[0].weight.copy_(_t(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        bn = v["params"]["BatchNorm_0"]
        port[1].weight.copy_(_t(bn["scale"]))
        port[1].bias.copy_(_t(bn["bias"]))
        port[1].running_mean.copy_(_t(v["batch_stats"]["BatchNorm_0"]["mean"]))
        port[1].running_var.copy_(_t(v["batch_stats"]["BatchNorm_0"]["var"]))
        got = port(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_only_stride1_biasfree_3x3_uses_conv3x3(monkeypatch):
    calls = []
    real = layers.conv3x3
    monkeypatch.setattr(layers, "conv3x3", lambda x, w: calls.append(x.shape) or real(x, w))
    x = torch.randn(1, 8, 8, 4)
    for kernel, stride, bias, expect in ((3, 1, False, 1), (3, 2, False, 0), (3, 1, True, 0),
                                         (1, 1, False, 0)):
        calls.clear()
        conv = layers.Conv2d(4, 4, kernel, stride, bias=bias)
        torch.nn.init.normal_(conv.weight)
        conv(x)
        assert len(calls) == expect, (kernel, stride, bias)
    assert conv2d.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("name", ["CenterHead", "CurriculumCenterHead", "CurriculumCenterHead_x5",
                                  "CurriculumCenterHead_car_merge",
                                  "CurriculumCenterHead_ped_merge"])
def test_center_head_names_are_registered(name):
    from com_tpu_torch.models.dense_heads.center_head import CenterHead
    from com_tpu_torch.utils.registry import DENSE_HEADS

    assert DENSE_HEADS.get(name) is CenterHead


def test_flax_module_names_are_stable():
    """The bridge addresses flax scopes by their auto names; guard them."""
    class Probe(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax_layers.ConvBNReLU(4, pallas=False)(x, train=False)

    v = Probe().init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 2)))
    assert set(v["params"]) == {"ConvBNReLU_0"}
    assert set(v["params"]["ConvBNReLU_0"]) == {"Conv_0", "BatchNorm_0"}
