"""PartA2 against the JAX package on the CPU, in eval (setup:
``tests/torch_port_parta2_setup.py``): ``inverse_conv3d`` (its rulebook
index for index, values and gradients; a (0, 1, 1) pad case),
``roiaware_pool3d`` at POOL_SIZE 12 (``max`` and ``avg``: a RoI past 512
members, empty cells, negative features, any RoI block), and the
PartA2Net forward: ``UNetV2``'s point features and encoded tensor,
``PointIntraPartOffsetHead`` and ``PartA2FCHead`` fed the JAX forward's
own inputs, the whole forward and the eval step's detections; the
PartA2-free forward (MeanVFE and UNetV2 under PointRCNN); both models'
state_dicts through the JAX package's pcdet importer; the two shipped
KITTI PartA2 configs against the JAX parameter counts (the Waymo one fails
alike in both packages: ``test_torch_port_voxel_model.py``).  Indices
exactly, f32 values to 1e-5 (ops) and 1e-4 (models).  One JAX jit of the
forward a model, and one of the eval step's post-processing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.ops import sparse as js
from com_tpu.ops.roiaware import roiaware_pool3d as jax_roiaware_pool3d
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops import sparse as ps
from com_tpu_torch.ops.roiaware import points_in_roi_local, roiaware_pool3d
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.step import model_input_keys
from com_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_port_slice import _match
from test_torch_port_voxel_model import VOXEL_KEYS
from torch_port_parta2_setup import REPO, setup

torch.set_num_threads(2)
ATOL = 1e-4
CONFIGS = ["configs/kitti_models/PartA2.yaml", "configs/kitti_models/PartA2_free.yaml"]


def t(a):
    return torch.from_numpy(np.array(a))


def inverse_case(pad):
    """A scene's sites and features (with invalid rows), their SparseConv3d
    output sites at stride 2 (the JAX engine's), and an inverse kernel."""
    rng = np.random.RandomState(3)
    grid = (9, 16, 16)
    c = np.unique(np.stack([rng.randint(0, g, 400) for g in grid], 1), axis=0).astype(np.int32)
    valid = rng.rand(len(c)) < 0.9
    _, oc, ov, dgrid = jax.jit(lambda c_, v_: js.strided_conv3d(
        jnp.zeros((len(c), 1)), c_, v_, jnp.zeros((27, 1, 1)), grid, 256, (2, 2, 2), 3,
        pad=pad))(c, valid)
    oc, ov = np.asarray(oc), np.asarray(ov)
    feats = rng.randn(len(oc), 6).astype(np.float32)
    w = rng.randn(27, 6, 5).astype(np.float32)
    return c, valid, oc, ov, dgrid, feats, w, rng.randn(len(c), 5).astype(np.float32)


@pytest.mark.parametrize("pad", [1, (0, 1, 1)])
def test_inverse_conv3d_matches_jax(pad):
    """The rulebook (each high-resolution site's low-resolution row a tap)
    index for index against the JAX engine's lookup; the output and both
    gradients (of features and kernel) to 1e-5; the backward table is the
    rulebook's inverse."""
    c, valid, oc, ov, dgrid, feats, w, g = inverse_case(pad)
    offs = jnp.asarray(js._inv_offsets(3, pad), jnp.int32)
    shifted = jnp.asarray(c)[None] - offs[:, None]
    lo = shifted // 2
    inb = ((shifted % 2 == 0).all(-1) & jnp.asarray(valid)[None]
           & (lo >= 0).all(-1) & (lo < jnp.asarray(dgrid)).all(-1))
    want_nidx = np.asarray(jax.jit(lambda *a: js._batched_lookup(*a[:2], dgrid, *a[2:]))(
        oc, ov, lo, inb))
    nidx, back = ps.batched_inverse_rulebook(t(oc)[None], t(ov)[None], dgrid, t(c)[None],
                                             t(valid)[None], 2, 3, pad)
    np.testing.assert_array_equal(nidx[0].numpy(), want_nidx)
    assert (want_nidx >= 0).sum() > len(c)  # several taps hit
    taps, rows = np.nonzero(nidx[0].numpy() >= 0)
    np.testing.assert_array_equal(back.numpy()[taps, nidx[0].numpy()[taps, rows]],
                                  rows * 27 + taps)

    def jax_fn(f, k):
        return js.inverse_conv3d(f, jnp.asarray(oc), jnp.asarray(ov), k, jnp.asarray(c),
                                 jnp.asarray(valid), dgrid, (2, 2, 2), 3, pad)

    want, (jgf, jgw) = jax.jit(lambda f, k: (jax_fn(f, k), jax.grad(
        lambda f_, k_: (jax_fn(f_, k_) * jnp.asarray(g)).sum(), argnums=(0, 1))(f, k)))(
        jnp.asarray(feats), jnp.asarray(w))
    want = np.asarray(want)
    f, k = t(feats).requires_grad_(), t(w).requires_grad_()
    got = ps.inverse_conv3d(f, t(oc), t(ov), k, t(c), t(valid), dgrid, (2, 2, 2), 3, pad)
    (got * t(g)).sum().backward()
    for a, b in ((got.detach(), want), (f.grad, jgf), (k.grad, jgw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    assert (np.abs(want).sum(-1)[~valid] == 0).all()


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(method):
    """POOL_SIZE 12, 512 points a RoI: a RoI with more than 512 members
    (the first 512 in index order), a small one, one far from every point,
    one of size 0; feature 1 negative everywhere (``max`` keeps it
    negative); exactly the JAX values, empty cells 0, at any RoI block."""
    rng = np.random.RandomState(5)
    n = 4000
    pts = rng.uniform(-4, 4, (2, n, 3)).astype(np.float32)
    valid = rng.rand(2, n) < 0.9
    feats = rng.randn(2, n, 5).astype(np.float32)
    feats[..., 1] = -np.abs(feats[..., 1]) - 0.5
    rois = np.array([[0, 0, 0, 6, 5, 4, 0.4], [2, -2, 0, 1.2, 1, 1, -1.1],
                     [40, 40, 0, 2, 2, 2, 0.0], [-2, 2, 0.5, 2.4, 1.6, 1.2, 2.0],
                     [0, 0, 0, 0, 1, 1, 0]], np.float32)
    rois = np.stack([rois, rois + np.float32([0.3, 0, 0, 0, 0, 0, 0.2])])
    want = np.asarray(jax.jit(jax.vmap(lambda p, f, v, r: jax_roiaware_pool3d(
        p, f, v, r, 12, 512, method)))(pts, feats, valid, rois))
    for block in (1 << 25, 1):
        got = roiaware_pool3d(t(pts), t(feats), t(valid), t(rois), 12, 512, method, block=block)
        assert got.shape == (2, 5, 12, 12, 12, 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    filled = np.abs(want).sum(-1) > 0
    cells = filled.sum((-1, -2, -3))
    assert (cells[:, 2] == 0).all() and (cells[:, 4] == 0).all() and (cells[:, 0] > 300).all()
    assert (want[..., 1][filled] < 0).all() and (want[..., 1][~filled] == 0).all()
    _, inside = points_in_roi_local(t(pts), t(rois[:, :1]))
    assert (inside[:, 0].numpy() & valid).sum(-1).min() > 512  # RoI 0: past 512 members


class Replay:
    """A stand-in for a flax network whose ``apply`` returns outputs it was
    given: the JAX eval step's post-processing, jitted alone, over the JAX
    forward's own outputs (compiling the forward twice costs ~10 s)."""

    def __init__(self, out):
        self.out = out

    def apply(self, variables, batch, train=False):
        return dict(self.out)


@pytest.fixture(scope="module")
def parta2():
    """The setup, the JAX eval forward's outputs, the JAX eval step's
    detections of them, the port's forward."""
    s = setup("parta2")
    cfg, jmeta, _, jnet, variables, net, host = s
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, {k: host[k] for k in VOXEL_KEYS})
    jdet = jax.jit(lambda o: jax_make_eval_step(Replay(o), cfg.MODEL, list(cfg.CLASS_NAMES),
                                                jmeta)(None, {}))(jout)
    jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.no_grad():
        out = net({k: t(host[k]) for k in VOXEL_KEYS})
    return s, jout, [np.asarray(d) for d in jdet], out


def check_close(got, want, keys):
    for k in keys:
        g, w = got[k].numpy(), want[k]
        if g.dtype == bool or g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "point_coords":  # the voxel centres, to f32 rounding
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=ATOL, atol=ATOL, err_msg=k)


def test_unet_v2_matches_jax(parta2):
    """UNetV2: the point features, centres and validity at the input sites,
    and conv_out's dense tensor (HeightCompression's input) to 1e-4."""
    (cfg, *_, net, host), jout, _, out = parta2
    assert type(net.backbone_3d).__name__ == "UNetV2"
    assert out["point_features"].shape == (2, 2048, 8)
    assert out["encoded_spconv_tensor"].shape == (2, 2, 8, 8, 128)
    check_close(out, jout, ["point_valid", "point_coords", "point_features",
                            "encoded_spconv_tensor", "spatial_features"])
    assert float(out["point_features"].abs().max()) > 1.0


def test_point_intra_part_head_matches_jax(parta2):
    """On the JAX forward's point features: the class logits, scores, part
    logits and offsets; the scores straddle SEG_MASK_SCORE_THRESH."""
    (cfg, *_, net, _), jout, _, _ = parta2
    with torch.no_grad():
        got = net.point_head({k: t(jout[k]) for k in ("point_features", "point_valid",
                                                        "point_coords")})
    check_close(got, jout, ["point_cls_preds", "point_cls_scores_raw", "point_cls_scores",
                            "point_part_logits", "point_part_offset"])
    seg = got["point_cls_scores"][got["point_valid"]]
    thresh = float(cfg.MODEL.ROI_HEAD.SEG_MASK_SCORE_THRESH)
    assert 0.05 < float((seg >= thresh).float().mean()) < 0.95


def test_parta2_fc_head_matches_jax(parta2):
    """On the JAX forward's RoIs and point outputs: the RoI-aware pools, the
    masked 3D convs and the FCs' class and box outputs."""
    (*_, net, _), jout, _, _ = parta2
    keys = ("rois", "point_coords", "point_features", "point_valid", "point_cls_scores",
            "point_part_offset")
    with torch.no_grad():
        batch = {k: t(jout[k]) for k in keys}
        pooled_part, _ = net.roi_head.pool(dict(batch))
        got = net.roi_head(batch)
    check_close(got, jout, ["rcnn_cls", "rcnn_reg"])
    nonempty = (pooled_part.abs().sum(-1) > 0).sum((1, 2, 3))
    assert (nonempty > 0).sum() >= 16 and float(got["rcnn_cls"].std()) > 0.01


def test_whole_forward_and_eval_step_match_jax(parta2):
    """The whole forward (point stage, proposals, RoIs, RCNN outputs) and
    the eval step's detections."""
    s, jout, jdet, out = parta2
    cfg, _, pmeta, _, _, net, host = s
    assert type(net).__name__ == "PartA2Net"
    assert model_input_keys(cfg.MODEL) == set(VOXEL_KEYS)
    check_close(out, jout, ["point_cls_scores", "point_part_offset", "rois", "roi_valid",
                            "roi_scores", "roi_labels", "rcnn_cls", "rcnn_reg"])
    assert out["roi_valid"].sum() >= 32
    jb, jsc, jl, jv = jdet
    boxes, scores, labels, valid = (x.numpy() for x in make_eval_step(
        net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta, device="cpu")(host))
    assert boxes.shape == jb.shape and labels.dtype == np.int32
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() >= 8
    for i in range(2):
        rows = lambda b, s_, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s_[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, jsc, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)


@pytest.fixture(scope="module")
def free():
    """PartA2-free's setup, the JAX eval forward's outputs, the port's."""
    s = setup("free")
    _, _, _, jnet, variables, net, host = s
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, {k: host[k] for k in VOXEL_KEYS})
    with torch.no_grad():
        out = net({k: t(host[k]) for k in VOXEL_KEYS})
    return s, jax.tree_util.tree_map(np.asarray, jout), out


def test_parta2_free_forward_matches_jax(free):
    """PartA2_free.yaml's composition (PointRCNN over MeanVFE and UNetV2,
    no encoded tensor; the part head with its box branch makes the
    proposals): the point outputs, proposals and RCNN outputs."""
    (cfg, *_, net, _), jout, out = free
    assert type(net).__name__ == "PointRCNN" and net.vfe is not None
    assert "encoded_spconv_tensor" not in out and not hasattr(net.backbone_3d, "conv_out")
    check_close(out, jout, ["point_features", "point_cls_preds", "point_part_logits",
                            "point_box_preds_raw", "point_box_preds", "point_pred_labels",
                            "rois", "roi_valid", "roi_scores", "roi_labels", "rcnn_cls",
                            "rcnn_reg"])
    assert out["roi_valid"].sum() >= 16


@pytest.mark.parametrize("which", ["parta2", "free"])
def test_state_dict_round_trip_through_jax_importer(which, parta2, free):
    """port state_dict -> the JAX package's pcdet importer -> the flax
    variables the port was loaded from: every key consumed (UNetV2's
    ``conv_up_t{k}`` bias-free blocks, ``conv_up_m{k}``, ``inv_conv{k}``,
    ``conv5``; the part head's ``part_reg_layers``; PartA2FCHead's
    ``conv_part`` / ``conv_rpn`` in spconv's layout and its Conv1d FCs),
    none unused; the eps-1e-5 norms through the importer's compensation."""
    (cfg, _, _, _, variables, net, _), *_ = parta2 if which == "parta2" else free
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert sd["backbone_3d.inv_conv4.0.weight"].shape == (16, 3, 3, 3, 32)
    assert sd["backbone_3d.conv_up_t4.conv1.weight"].shape == (32, 3, 3, 3, 32)
    assert "backbone_3d.conv_up_t4.conv1.bias" not in sd
    assert sd["backbone_3d.conv5.0.0.weight"].shape == (8, 3, 3, 3, 8)
    assert sd["point_head.part_reg_layers.3.weight"].shape == (3, 16)
    if which == "parta2":
        assert sd["roi_head.conv_part.0.0.weight"].shape == (64, 3, 3, 3, 4)
        assert sd["roi_head.conv_rpn.1.0.weight"].shape == (8, 3, 3, 3, 64)
        assert sd["roi_head.shared_fc_layer.0.weight"].shape == (32, 4 ** 3 * 16, 1)
        assert sd["roi_head.reg_layers.4.weight"].shape == (7, 32, 1)  # past the dropout slot
    else:
        assert sd["point_head.box_layers.3.weight"].shape == (8, 16)
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["mismatch"] and not report["missing"] and not report["unused"], report
    flat_new = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(p, "key", None) for p in path]
        np.testing.assert_allclose(np.asarray(flat_new[path]), np.asarray(leaf), rtol=0,
                                   atol=1e-6 if keys[-1] == "var" else 0, err_msg=str(keys))


def meta_of(cfg, meta_cls):
    pr = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    return meta_cls(cfg.CLASS_NAMES, pr, [0.1, 0.1, 0.1], [16, 16, 40],
                    len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list))


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_parta2_configs_build_with_jax_parameter_counts(config):
    """Each shipped KITTI PartA2 config builds at its widths (the full 12^3 x 128
    grid into SHARED_FC: 56.6 M weights in shared_fc_layer.0), with as
    many parameters in every slot as the JAX package's (``jax.eval_shape``
    of its init over 2 scenes of 256 voxels at a 16 x 16 x 40 grid: no
    compile)."""
    cfg = cfg_from_yaml_file(str(REPO / config))
    net = build_network(cfg.MODEL, meta_of(cfg, DatasetMeta), device="cpu")
    jcfg = jax_cfg_from_yaml_file(str(REPO / config))
    jnet = jax_build_network(jcfg.MODEL, meta_of(jcfg, JaxMeta))
    f = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    shapes = jax.eval_shape(lambda k, b: jnet.init(k, b, train=False), jax.random.PRNGKey(0),
                            {"voxels": jax.ShapeDtypeStruct((2, 256, 5, f), jnp.float32),
                             "voxel_coords": jax.ShapeDtypeStruct((2, 256, 3), jnp.int32),
                             "voxel_num_points": jax.ShapeDtypeStruct((2, 256), jnp.int32)})

    def count(tree):
        return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))

    slots = {"backbone_3d": "UNetV2_0", "point_head": "point_head", "roi_head": "roi_head"}
    if "DENSE_HEAD" in cfg.MODEL:
        slots.update(backbone_2d="BaseBEVBackbone_0", dense_head="AnchorHeadSingle_0")
        assert net.state_dict()["roi_head.shared_fc_layer.0.weight"].shape == (256, 221184, 1)
    for slot, scope in slots.items():
        got = sum(p.numel() for n, p in net.named_parameters() if n.startswith(slot + "."))
        assert got == count(shapes["params"][scope]), slot
    assert sum(p.numel() for p in net.parameters()) == count(shapes["params"])


@pytest.mark.parametrize("which", ["parta2", "free"])
def test_chip_smoke_small_case_is_the_tests_config(which):
    """``chip_smoke.parta2_small_case`` writes ``small_cfg``'s narrowing out
    (the card imports no JAX-side test): the same model config."""
    from chip_smoke import parta2_small_case
    from torch_port_parta2_setup import small_cfg

    def plain(node):
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return [plain(v) for v in node] if isinstance(node, (list, tuple)) else node

    cfg, meta, batch = parta2_small_case(which)
    assert plain(cfg.MODEL) == plain(small_cfg(which).MODEL)
    assert batch["voxels"].shape == (2, 8192, 5, 4) and meta.grid_size == (64, 64, 40)
