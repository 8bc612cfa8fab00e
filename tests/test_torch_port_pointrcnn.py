"""PointRCNN against the JAX package on the CPU, in eval (setup:
``tests/torch_port_pointrcnn_setup.py``): ``PointResidualCoder``,
``roipoint_pool3d`` (ties, fewer members than slots, an empty RoI, fewer
points than slots, any block size), ``PointNet2MSG``'s sampling and
grouping indices and features, ``PointHeadBox`` and ``PointRCNNHead`` fed
the JAX forward's own inputs, the whole forward and the eval step's
detections; the state_dict through the JAX package's pcdet importer; the
three shipped PointRCNN configs at their widths against the JAX
parameter counts.  Indices exactly, values and detections to 1e-4 (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.ops import pointnet2 as jax_pn2
from com_tpu.ops.boxes import PointResidualCoder as JaxCoder
from com_tpu.ops.roiaware import roipoint_pool3d as jax_roipoint_pool3d
from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops import pointnet2 as pn2
from com_tpu_torch.ops.boxes import PointResidualCoder
from com_tpu_torch.ops.roiaware import roipoint_pool3d
from com_tpu_torch.train.step import model_input_keys
from com_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_port_two_stage_model import check_eval
from torch_port_kitti_setup import REPO
from torch_port_pointrcnn_setup import INPUT_KEYS, setup

torch.set_num_threads(2)
ATOL = 1e-4
CONFIGS = ["configs/kitti_models/pointrcnn.yaml", "configs/kitti_models/pointrcnn_iou.yaml",
           "configs/waymo_models/pointrcnn.yaml"]


@pytest.fixture(scope="module")
def pointrcnn():
    """The setup, the JAX eval forward's outputs (numpy) and the port's."""
    s = setup()
    _, _, _, jnet, variables, net, host = s
    jin = {k: host[k] for k in INPUT_KEYS}
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(variables, jin)
    jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.no_grad():
        out = net({k: torch.from_numpy(host[k]) for k in INPUT_KEYS})
    return s, jout, out


def t(a):
    return torch.from_numpy(np.array(a))


def check_close(got, want, keys):
    for k in keys:
        g, w = got[k].numpy(), want[k]
        if g.dtype == bool or g.dtype.kind in "iu" or k == "point_coords":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=ATOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("use_mean_size", [True, False])
def test_point_residual_coder_matches_jax(use_mean_size):
    """Encode (boxes against points, 1-based classes) and decode, with the
    KITTI config's mean sizes or without them."""
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-20, 20, (64, 3)), rng.uniform(0.3, 5, (64, 3)),
                            rng.uniform(-3.1, 3.1, (64, 1))], 1).astype(np.float32)
    points = (boxes[:, :3] + rng.randn(64, 3)).astype(np.float32)
    classes = rng.randint(1, 4, 64).astype(np.int32)
    mean = [[4.7, 2.1, 1.7], [0.91, 0.86, 1.73], [1.78, 0.84, 1.78]]
    jc = JaxCoder(use_mean_size=use_mean_size, mean_size=mean)
    pc = PointResidualCoder(use_mean_size=use_mean_size, mean_size=mean)
    want = np.asarray(jc.encode(jnp.asarray(boxes), jnp.asarray(points), jnp.asarray(classes),
                                xp=jnp))
    got = pc.encode(t(boxes), t(points), t(classes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    codes = (want + rng.randn(*want.shape) * 0.1).astype(np.float32)
    want = np.asarray(jc.decode(jnp.asarray(codes), jnp.asarray(points), jnp.asarray(classes),
                                xp=jnp))
    np.testing.assert_allclose(pc.decode(t(codes), t(points), t(classes)).numpy(), want,
                               rtol=1e-6, atol=1e-5)


def pool_case(case):
    """(points (2, N, 3), feats (2, N, 2): the point's index and a value,
    valid, rois (2, 4, 7), K) for ``case``."""
    rng = np.random.RandomState(5)
    n, k = (40, 64) if case == "fewer_points" else (3000, 64)
    pts = rng.uniform(-4, 4, (2, n, 3)).astype(np.float32)
    valid = rng.rand(2, n) < 0.9
    rois = np.array([[0, 0, 0, 3, 2.5, 2, 0.4],  # many members: the first K by index
                     [2, -2, 0, 1.2, 1, 1, -1.1],  # fewer than K members
                     [40, 40, 0, 2, 2, 2, 0.0],  # empty
                     [-2, 2, 0.5, 2.4, 1.6, 1.2, 2.0]], np.float32)
    rois = np.stack([rois, rois + np.float32([0.3, 0, 0, 0, 0, 0, 0.2])])
    if case == "ties":  # duplicated points: equal keys and equal coordinates
        pts[:, 1::2] = pts[:, 0:-1:2]
    feats = np.stack([np.broadcast_to(np.arange(n, dtype=np.float32), (2, n)),
                      rng.randn(2, n).astype(np.float32)], -1)
    return pts, feats, valid, rois, k


@pytest.mark.parametrize("case", ["members", "ties", "fewer_points"])
def test_roipoint_pool3d_matches_jax(case):
    """The same member points in the same slots (their indices ride in
    feature 0), exactly; the local coordinates to 1e-6; the empty flags.
    Past a RoI's last member the slots are zeros in both packages (pcdet
    repeats the sampled points there instead), and the RoI far from every
    point is empty.  The result does not depend on the RoI block size."""
    pts, feats, valid, rois, k = pool_case(case)
    jout, jempty = jax.vmap(lambda p, f, v, r: jax_roipoint_pool3d(p, f, v, r, k))(
        pts, feats, valid, rois)
    jout, jempty = np.asarray(jout), np.asarray(jempty)
    outs = [roipoint_pool3d(t(pts), t(feats), t(valid), t(rois), k, block=blk)
            for blk in (pn2.QUERY_BLOCK, 1)]
    for out, empty in outs:
        np.testing.assert_array_equal(empty.numpy(), jempty)
        np.testing.assert_array_equal(out[..., 3:].numpy(), jout[..., 3:])
        np.testing.assert_allclose(out[..., :3].numpy(), jout[..., :3], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    filled = np.abs(jout).sum(-1) > 0
    members = filled.sum(-1)
    assert (members[:, 2] == 0).all() and jempty[:, 2].all()
    # the members come first, in index order, and the rest of the slots are 0
    assert (filled == (np.arange(k) < members[..., None])).all()
    for s in range(2):
        for r in range(4):
            m = members[s, r]
            assert (np.diff(jout[s, r, :m, 3]) > 0).all()
            assert (jout[s, r, m:] == 0).all()
    if case != "fewer_points":
        assert (members[:, 0] == k).all()
        assert ((members[:, 1] > 0) & (members[:, 1] < k)).all()


def test_pointnet2_msg_matches_jax(pointrcnn):
    """The first set abstraction's FPS and its two ball queries, index for
    index, and every point's propagated features."""
    (cfg, _, _, _, _, net, host), jout, out = pointrcnn
    sa = net.backbone_3d.SA_modules[0]
    xyz, valid = host["points"][..., :3], host["points_mask"]
    jidx = np.asarray(jax.vmap(lambda x, v: jax_pn2.farthest_point_sample(x, v, sa.npoint))(
        xyz, valid))
    idx = pn2.farthest_point_sample(t(xyz), t(valid), sa.npoint)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    new_xyz = np.take_along_axis(xyz, jidx[..., None], 1)
    for r, ns in zip(sa.radii, sa.nsamples):
        jq = jax.vmap(lambda x, nx, v: jax_pn2.ball_query(r, ns, x, nx, valid=v)[0])(
            xyz, new_xyz, valid)
        q = pn2.ball_query(r, ns, t(xyz), t(new_xyz), t(valid))[0]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=f"radius {r}")
    assert out["point_features"].shape == (2, 1024, 16)
    check_close(out, jout, ["point_coords", "point_valid", "point_features"])


def test_point_head_box_matches_jax(pointrcnn):
    """On the JAX forward's point features: class logits, box codes, scores,
    decoded boxes and labels."""
    (_, _, _, _, _, net, _), jout, _ = pointrcnn
    with torch.no_grad():
        got = net.point_head({k: t(jout[k]) for k in ("point_features", "point_valid",
                                                        "point_coords")})
    check_close(got, jout, ["point_cls_preds", "point_box_preds_raw", "point_cls_scores",
                            "point_box_preds", "point_pred_labels"])
    scores = got["point_cls_scores"]
    assert float(scores.min()) < 0.5 and float(scores.std()) > 0.1  # spread


def test_pointrcnn_head_matches_jax(pointrcnn):
    """On the JAX forward's RoIs and points: the pooled RoIs' class and box
    outputs."""
    (_, _, _, _, _, net, _), jout, _ = pointrcnn
    with torch.no_grad():
        got = net.roi_head({k: t(jout[k]) for k in ("rois", "point_coords", "point_features",
                                                     "point_valid", "point_cls_scores")})
    check_close(got, jout, ["rcnn_cls", "rcnn_reg"])


def test_whole_forward_and_eval_step_match_jax(pointrcnn):
    """The whole forward (points, proposals, RCNN outputs) and the eval
    step's detections, labelled by the point head's classes."""
    s, jout, out = pointrcnn
    assert type(s[5]).__name__ == "PointRCNN"
    assert model_input_keys(s[0].MODEL) == {"points", "points_mask"}
    check_close(out, jout, ["point_features", "point_cls_scores", "point_pred_labels", "rois",
                            "roi_valid", "roi_scores", "roi_labels", "rcnn_cls", "rcnn_reg"])
    assert out["roi_valid"].sum() >= 8
    valid = check_eval(*s, min_valid=4)
    assert valid.shape == (2, 16)


def test_pointrcnn_state_dict_round_trip_through_jax_importer(pointrcnn):
    """port state_dict -> the JAX package's pcdet importer -> the flax
    variables the bridge started from: every key loaded (pcdet's names:
    ``backbone_3d.SA_modules.{k}.mlps.{r}`` and ``FP_modules.{i}.mlp``
    Conv2d (O, I, 1, 1), the point head's Linear layers, the RoI head's
    Conv2d shared MLPs, SA modules and Conv1d FCs with their dropout slot),
    none unused; the norms pcdet built with eps 1e-5 read back through the
    importer's compensation."""
    (cfg, _, _, _, variables, net, _), _, _ = pointrcnn
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert sd["backbone_3d.SA_modules.1.mlps.1.3.weight"].shape == (16, 16, 1, 1)
    assert sd["backbone_3d.FP_modules.0.mlp.0.weight"].shape == (16, 2 + 16, 1, 1)
    assert sd["point_head.box_layers.3.weight"].shape == (8, 32)
    assert sd["roi_head.merge_down_layer.0.weight"].shape == (16, 32, 1, 1)
    assert sd["roi_head.SA_modules.1.mlps.0.0.weight"].shape == (16, 3 + 16, 1, 1)
    assert sd["roi_head.reg_layers.4.weight"].shape == (7, 16, 1)  # past the dropout slot
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["mismatch"] and not report["missing"] and not report["unused"], report
    flat_new = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "var":
            np.testing.assert_allclose(np.asarray(flat_new[path]), np.asarray(leaf), rtol=0,
                                       atol=1e-6, err_msg=str(keys))
        else:
            np.testing.assert_array_equal(np.asarray(flat_new[path]), np.asarray(leaf),
                                          err_msg=str(keys))


def meta_of(cfg, meta_cls):
    pr = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    return meta_cls(cfg.CLASS_NAMES, pr, [0.1, 0.1, 0.1], [16, 16, 16],
                    len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list))


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_configs_build_with_jax_parameter_counts(config):
    """Each shipped PointRCNN config builds at its widths, the slots under
    pcdet's names, with as many parameters in every module as the JAX
    package's (``jax.eval_shape`` of its init on 2 scenes of 16,384
    points: no compile)."""
    cfg = cfg_from_yaml_file(str(REPO / config))
    net = build_network(cfg.MODEL, meta_of(cfg, DatasetMeta), device="cpu")
    assert type(net).__name__ == "PointRCNN"
    jcfg = jax_cfg_from_yaml_file(str(REPO / config))
    jnet = jax_build_network(jcfg.MODEL, meta_of(jcfg, JaxMeta))
    f = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    shapes = jax.eval_shape(lambda k, b: jnet.init(k, b, train=False), jax.random.PRNGKey(0),
                            {"points": jax.ShapeDtypeStruct((2, 16384, f), jnp.float32),
                             "points_mask": jax.ShapeDtypeStruct((2, 16384), jnp.bool_)})
    for slot in ("backbone_3d", "point_head", "roi_head"):
        want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            shapes["params"][slot]))
        got = sum(p.numel() for n, p in net.named_parameters() if n.startswith(slot + "."))
        assert got == want, slot
    assert sum(p.numel() for p in net.parameters()) > 4_000_000


def test_chip_smoke_small_case_is_the_jax_tests_config():
    """``chip_smoke.pointrcnn_small_case`` writes ``tests/test_pointrcnn.py``'s
    ``pointrcnn_cfg`` out (the card imports no JAX-side test): the same
    model config."""
    from chip_smoke import pointrcnn_small_case
    from test_pointrcnn import pointrcnn_cfg

    def plain(node):
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return [plain(v) for v in node] if isinstance(node, (list, tuple)) else node

    cfg, meta, batch = pointrcnn_small_case()
    assert plain(cfg.MODEL) == plain(pointrcnn_cfg())
    assert batch["points"].shape == (2, 1024, 5) and meta.num_point_features == 5


def test_parta2_free_raises_by_name():
    """PartA2_free.yaml's PointRCNN (MeanVFE and UNetV2 give the point
    features) is not ported."""
    cfg = cfg_from_yaml_file(str(REPO / "configs/kitti_models/PartA2_free.yaml"))
    with pytest.raises(NotImplementedError, match="UNetV2"):
        build_network(cfg.MODEL, meta_of(cfg, DatasetMeta), device="cpu")
