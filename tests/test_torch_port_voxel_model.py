"""The port's sparse-voxel detectors against the JAX package on the CPU:
``VoxelBackBone8x`` / ``VoxelResBackBone8x``, ``HeightCompression``,
CenterPoint-voxel with COMLoss (``configs/waymo_models/com/
centerpoint_voxel_comloss.yaml``) serving (its train step is
``test_torch_port_voxel_train.py``'s), SECONDNet
(``configs/kitti_models/second.yaml``) serving; the weight bridge and the
JAX package's pcdet importer both ways, a spconv 1.x checkpoint, the Waymo
SECOND grid fault both packages share, and the names that raise.

Scenes are ``tests/test_second_voxel_path.py``'s: 4,000 points a scene in
+-15 m, hard-voxelized at 0.5 x 0.5 x 0.1 m into a 64 x 64 x 40 grid (2,048
voxel slots, 5 points each); the models are the YAMLs narrowed (3D
``CHANNELS`` [8, 16, 16, 32], ``OUT_CHANNELS`` 32, ``VOXEL_CAPS`` [2048, 1024,
512, 256], a one-layer BEV backbone), in f32.  The JAX variables are
perturbed from a seed (norm biases +3, as ``test_torch_port_train_common``
sets out) and carried into the port by its weight bridge.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.models.map_to_bev import HeightCompression as JaxHeightCompression
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.models.map_to_bev import HeightCompression
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.utils.checkpoint import load_params_only
from com_tpu_torch.utils.jax_weights import load_jax_variables
from com_tpu_torch.utils.registry import BACKBONES_3D, MAP_TO_BEV, VFES
from test_second_voxel_path import make_voxel_batch
from test_torch_port_slice import _match

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
VOXEL_CFG = "configs/waymo_models/com/centerpoint_voxel_comloss.yaml"
KITTI_SECOND = "configs/kitti_models/second.yaml"
WAYMO_SECOND = "configs/waymo_models/second.yaml"
WAYMO_VOXEL_RCNN = "configs/waymo_models/voxel_rcnn.yaml"
WAYMO_SECOND_IOU = "configs/waymo_models/second_iou.yaml"
WAYMO_PARTA2 = "configs/waymo_models/PartA2.yaml"
WAYMO_PV_RCNN = ["configs/waymo_models/pv_rcnn.yaml", "configs/waymo_models/pv_rcnn_plusplus.yaml",
                 "configs/waymo_models/pv_rcnn_plusplus_resnet.yaml",
                 "configs/waymo_models/pv_rcnn_plusplus_resnet_2frames.yaml"]
GRID = (64, 64, 40)
VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points")
ATOL = 1e-4


def narrow(cfg, backbone="VoxelBackBone8x"):
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D.update(NAME=backbone, CHANNELS=[8, 16, 16, 32], OUT_CHANNELS=32,
                         VOXEL_CAPS=[2048, 1024, 512, 256])
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[32, 64],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[32, 32])
    if "SHARED_CONV_CHANNEL" in m.DENSE_HEAD:
        m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
        m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 16
    return cfg


def scenes(seed=0, m=16):
    """Voxelized scenes and 6 objects a scene of the three classes in 16
    slots, with the COM side arrays; plus the pc range and voxel size."""
    rng = np.random.RandomState(seed)
    batch, pc_range, vsize = make_voxel_batch(rng)
    host = {k: np.array(batch[k]) for k in VOXEL_KEYS}
    b = host["voxels"].shape[0]
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-12, 12, (b, 6, 2))
    gt[:, :6, 2] = rng.uniform(-0.5, 0.5, (b, 6))
    gt[:, :6, 3:6] = rng.uniform(1.0, 4.0, (b, 6, 3))
    gt[:, :6, 6] = rng.uniform(-np.pi, np.pi, (b, 6))
    gt[:, :6, 7] = rng.randint(1, 4, (b, 6))
    real = gt[..., 7] > 0
    host.update(gt_boxes=gt, num_points_in_gt=real.astype(np.float32) * 10,
                true_object=real.astype(np.float32),
                occupancy_ratio=rng.rand(b, m).astype(np.float32),
                facade_type=rng.randint(0, 4, (b, m)).astype(np.float32))
    return host, pc_range, vsize


def metas(cfg, pc_range, vsize):
    names = list(cfg.CLASS_NAMES)
    return (JaxMeta(names, pc_range, vsize, GRID, 5),
            DatasetMeta(names, pc_range, vsize, GRID, 5))


def jax_variables(jnet, host, seed=1):
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in VOXEL_KEYS}, train=False)
    return common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=seed)


def inputs(host):
    return {k: torch.from_numpy(np.array(host[k])) for k in VOXEL_KEYS}


@pytest.fixture(scope="module")
def voxel_setup():
    """CenterPoint-voxel (COMLoss) in both packages, the same weights; the
    size head's kernel shrunk so that exp(dim) stays a box size (at the
    perturbed weights' ~10 it reaches thousands of metres, and f32 rounding
    of those passes 1e-4)."""
    host, pc_range, vsize = scenes()
    cfg = narrow(cfg_from_yaml_file(str(REPO / VOXEL_CFG)))
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax_variables(jnet, host)
    head = next(v for k, v in variables["params"].items() if k.startswith("CenterHead"))
    head["head_0"]["dim_out"]["kernel"] = head["head_0"]["dim_out"]["kernel"] * np.float32(0.02)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    return cfg, jmeta, pmeta, jnet, variables, net, host


@pytest.mark.parametrize("backbone", ["VoxelBackBone8x", "VoxelResBackBone8x"])
def test_voxel_backbone_matches_jax(backbone):
    """The dense output, and every stage's sites (exactly) and features."""
    host, pc_range, vsize = scenes(seed=3)
    cfg = narrow(cfg_from_yaml_file(str(REPO / VOXEL_CFG)), backbone)
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax_variables(jnet, host, seed=4)
    want = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, {k: host[k] for k in VOXEL_KEYS})
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    with torch.no_grad():
        got = net(inputs(host))
    dense = got["encoded_spconv_tensor"].numpy()
    assert dense.shape == (2, 2, 8, 8, 32) and np.abs(dense).max() > 1.0
    np.testing.assert_allclose(dense, np.asarray(want["encoded_spconv_tensor"]), atol=ATOL,
                               rtol=ATOL)
    for s in range(1, 5):
        (x, c, v, g), (jx, jc, jv, jg) = (d["multi_scale_3d_features"][f"x_conv{s}"]
                                          for d in (got, want))
        assert tuple(g) == tuple(jg)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(c.numpy()[v.numpy()], np.asarray(jc)[np.asarray(jv)])
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=ATOL, rtol=ATOL)
    # stage 2 holds more sites than its cap: the overflow is exercised
    assert int(got["multi_scale_3d_features"]["x_conv2"][2].sum(1).max()) == 1024


def test_height_compression_channel_order_alike():
    """Both packages fold z as channel d*C + c (pcdet orders c*D + d; ROADMAP
    Queue 3 keeps the finding): the same dense input, the same BEV map."""
    dense = np.random.RandomState(5).randn(2, 2, 3, 4, 6).astype(np.float32)
    want = JaxHeightCompression(model_cfg={}).apply(
        {}, {"encoded_spconv_tensor": jnp.asarray(dense)})["spatial_features"]
    got = HeightCompression()({"encoded_spconv_tensor": torch.from_numpy(dense)})
    np.testing.assert_array_equal(got["spatial_features"].numpy(), np.asarray(want))
    d, c = 1, 4
    np.testing.assert_array_equal(got["spatial_features"][..., d * 6 + c].numpy(),
                                  dense[:, d, ..., c])
    assert got["spatial_features_stride"] == 8


def test_centerpoint_voxel_eval_step_matches_jax(voxel_setup):
    cfg, jmeta, pmeta, jnet, variables, net, host = voxel_setup
    names = list(cfg.CLASS_NAMES)
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    step = make_eval_step(net, cfg.MODEL, names, pmeta, device="cpu")
    boxes, scores, labels, valid = (t.numpy() for t in step(host))
    assert boxes.shape == jb.shape == (2, 500, 7)
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 10
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)


@pytest.fixture(scope="module")
def second_setup():
    """SECONDNet from the KITTI YAML over the same scenes, its class bias
    raised and box kernel shrunk as the anchor eval tests do (scores spread
    and boxes stay near their anchors)."""
    host, pc_range, vsize = scenes(seed=7)
    cfg = narrow(cfg_from_yaml_file(str(REPO / KITTI_SECOND)))
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax_variables(jnet, host, seed=8)
    head = variables["params"]["AnchorHeadSingle_0"]
    head["conv_cls"]["bias"] = head["conv_cls"]["bias"] + np.float32(4.0)
    head["conv_box"]["kernel"] = head["conv_box"]["kernel"] * np.float32(0.02)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    return cfg, jmeta, pmeta, jnet, variables, net, host


def test_secondnet_eval_step_matches_jax(second_setup):
    cfg, jmeta, pmeta, jnet, variables, net, host = second_setup
    names = list(cfg.CLASS_NAMES)
    assert type(net).__name__ == "SECONDNet"
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    boxes, scores, labels, valid = (t.numpy() for t in make_eval_step(
        net, cfg.MODEL, names, pmeta, device="cpu")(host))
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 10
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)


@pytest.mark.parametrize("which", ["voxel", "second"])
def test_state_dict_round_trip_through_jax_importer(which, voxel_setup, second_setup):
    """port state_dict (spconv 2.x layout) -> the JAX package's pcdet
    importer -> the flax variables the bridge started from, every tensor
    used."""
    cfg, _, _, _, variables, net, _ = voxel_setup if which == "voxel" else second_setup
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert sd["backbone_3d.conv_input.0.weight"].shape == (8, 3, 3, 3, 5)
    assert sd["backbone_3d.conv_out.0.weight"].shape == (32, 3, 1, 1, 32)
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["missing"] and not report["mismatch"] and not report["unused"], report
    flat_b = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_load_params_only_spconv1x_layout(voxel_setup, tmp_path):
    """A pcdet file whose sparse conv weights are spconv 1.x's (kz, ky, kx,
    Cin, Cout) loads into the port as its 2.x weights."""
    cfg, _, pmeta, _, _, net, host = voxel_setup
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    old = {k: (v.permute(1, 2, 3, 4, 0).contiguous() if v.dim() == 5 else v)
           for k, v in sd.items()}
    assert old["backbone_3d.conv2.0.0.weight"].shape == (3, 3, 3, 8, 16)
    torch.save({"model_state": old}, tmp_path / "pcdet_spconv1.pth")
    fresh = build_network(cfg.MODEL, pmeta, device="cpu", seed=11)
    loaded, skipped = load_params_only(tmp_path / "pcdet_spconv1.pth", fresh)
    assert skipped == 0 and loaded == len(sd)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("config", [WAYMO_SECOND, WAYMO_VOXEL_RCNN, WAYMO_SECOND_IOU]
                         + WAYMO_PV_RCNN + [WAYMO_PARTA2])
def test_waymo_second_grid_fails_alike(config):
    """``configs/waymo_models/second.yaml``: the Waymo range at 0.1 m is 1498
    cells, the backbone's stride-2 convs round up (1498 -> 749 -> 375 ->
    188) and the anchors are 1498 // 8 = 187 a side.  At a grid with the same
    remainder mod 8 (58: 29, 15, 8 against 7) both packages fail in the
    anchor decode; neither crops.  ``waymo_models/voxel_rcnn.yaml`` and
    ``second_iou.yaml`` have the same grid and anchors; their decode feeds
    the proposal layer inside the model, so both packages fail in the
    forward.  So do ``pv_rcnn.yaml`` and the ``pv_rcnn_plusplus*.yaml``
    (the 2-frame one at the model: its multi-frame dataset is not read
    here), their keypoints (cut to 256) drawn from raw points first.
    ``PartA2.yaml`` has the same grid (its 0.15 m z keeps 40 planes), its
    UNetV2 the same encoder; its PartA2FCHead at full width."""
    from com_tpu_torch.models.backbone3d import VoxelBackBone8x

    cfg = cfg_from_yaml_file(str(REPO / config))
    pr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
    full = int(round((pr[3] - pr[0]) / 0.1))
    assert full == 1498 and full % 8 == 58 % 8
    assert VoxelBackBone8x(cfg.MODEL.BACKBONE_3D, 5, (full, full, 40)).out_grid == (2, 188, 188)
    backbone = cfg.MODEL.BACKBONE_3D.NAME
    narrow(cfg, backbone if backbone == "UNetV2" else "VoxelBackBone8x")
    names = list(cfg.CLASS_NAMES)
    half = 58 * 0.5 / 2
    pc_range, vsize, grid = (-half, -half, -2.0, half, half, 2.0), (0.5, 0.5, 0.1), (58, 58, 40)
    host, _, _ = scenes(seed=9)
    keys = VOXEL_KEYS
    if "PFE" in cfg.MODEL:
        cfg.MODEL.PFE.NUM_KEYPOINTS = 256
        rng = np.random.RandomState(9)
        host.update(points=np.concatenate([rng.uniform(-14, 14, (2, 2048, 2)),
                                           rng.uniform(-1.5, 1.5, (2, 2048, 1)),
                                           rng.rand(2, 2048, 2)], -1).astype(np.float32),
                    points_mask=np.ones((2, 2048), bool))
        keys = VOXEL_KEYS + ("points", "points_mask")
    jnet = jax_build_network(cfg.MODEL, JaxMeta(names, pc_range, vsize, grid, 5))
    meta = DatasetMeta(names, pc_range, vsize, grid, 5)
    net = build_network(cfg.MODEL, meta, device="cpu")
    # 8 x 8 BEV cells x 6 anchors against 7 x 7 x 6, in the box decode of both
    if "ROI_HEAD" in cfg.MODEL:
        with pytest.raises(TypeError, match=r"384.*294"):
            jax.eval_shape(lambda b: jnet.init(jax.random.PRNGKey(0), b, train=False),
                           {k: jnp.asarray(host[k]) for k in keys})
        with pytest.raises(RuntimeError, match=r"384.*294"):
            make_eval_step(net, cfg.MODEL, names, meta, device="cpu")(host)
        return
    jvars = jax_variables(jnet, host)
    with pytest.raises(TypeError, match=r"384.*294"):
        jax.eval_shape(jax_make_eval_step(jnet, cfg.MODEL, names,
                                          JaxMeta(names, pc_range, vsize, grid, 5)),
                       jvars, {k: jnp.asarray(host[k]) for k in VOXEL_KEYS})
    with pytest.raises(RuntimeError, match=r"384.*294"):
        make_eval_step(net, cfg.MODEL, names, meta, device="cpu")(host)


@pytest.mark.parametrize("registry,name", [
    (BACKBONES_3D, "VoxelBackBone8xFocal"), (BACKBONES_3D, "UNetV2"),
    (VFES, "PillarVFE"), (VFES, "DynamicMeanVFE"),
    (MAP_TO_BEV, "PointPillarScatter"), (MAP_TO_BEV, "Conv2DCollapse")])
def test_unported_voxel_names_raise_by_name(registry, name):
    """The unported names raise by name; UNetV2, DynamicMeanVFE,
    VoxelBackBone8xFocal and Conv2DCollapse, ported, build from their
    defaults (the JAX modules' own: DynamicMeanVFE's 60,000 voxel slots,
    focal convs at stages 0 and 1, 256 BEV channels)."""
    if name == "VoxelBackBone8xFocal":
        focal = registry.get(name)({}, 5, (64, 64, 40), (0.5, 0.5, 0.1), (-16, -16, -2, 16, 16, 2))
        assert focal.focal_stages == {0, 1} and not focal.use_img
        assert len(focal.conv1) == 2 and len(focal.conv2) == 4 and len(focal.conv3) == 3
        return
    if name == "Conv2DCollapse":
        collapse = registry.get(name)({}, 1600)
        assert collapse.num_bev_features == 256
        assert tuple(collapse.block.conv.weight.shape) == (256, 1600, 1, 1)
        return
    if name == "UNetV2":
        unet = registry.get(name)({}, 5, (64, 64, 40), (0.5, 0.5, 0.1), (-16, -16, -2, 16, 16, 2))
        assert unet.num_point_features == 16 and unet.num_bev_features == 256
        return
    if name == "DynamicMeanVFE":
        vfe = registry.get(name)({}, 5, (0.5, 0.5, 0.1), (-16, -16, -2, 16, 16, 2), (64, 64, 40))
        assert vfe.max_voxels == 60000 and vfe.num_point_features == 5
        return
    with pytest.raises(NotImplementedError, match=name):
        registry.get(name)({}, 5, (64, 64, 40))


def test_unported_voxel_options_raise_by_name():
    from com_tpu_torch.models.backbone3d import SemSegEncoder

    # SemSegEncoder, which raised until the focal backbone, builds: (B, H, W,
    # 3) -> (B, H/4, W/4, out_channels)
    enc = SemSegEncoder(8)
    assert enc(torch.zeros(1, 16, 40, 3)).shape == (1, 4, 10, 8)
    with pytest.raises(NotImplementedError, match="VOXELIZE_ON_DEVICE"):
        VFES.get("MeanVFE")({"VOXELIZE_ON_DEVICE": True}, 5)
