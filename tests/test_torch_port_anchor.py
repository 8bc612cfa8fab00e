"""The port's anchor-head family against the JAX package on the CPU:
anchors, the residual box coder, target assignment, the anchor losses and
COMLoss; the pieces that raise by name, and the Waymo PointPillars grid
fault both packages share.  Also the KITTI PointPillars setup at a 64x64
grid that ``test_torch_port_anchor_{eval,train}.py`` share.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.losses import anchor_losses as jl
from com_tpu.models.dense_heads import anchor_assign as jassign
from com_tpu.models.dense_heads.anchor_head import build_anchors as jax_build_anchors
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.ops.boxes import ResidualCoder as JaxCoder
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.losses import anchor_losses as pl
from com_tpu_torch.models.dense_heads import anchor_assign as passign
from com_tpu_torch.models.dense_heads.anchor_head import build_anchors
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops.boxes import ResidualCoder
from test_torch_port_train_common import perturb

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
KITTI_PP = "configs/kitti_models/pointpillar.yaml"
WAYMO_PP = "configs/waymo_models/pointpillar.yaml"
GRID = (64, 64, 1)
VSIZE = (0.16, 0.16, 4.0)
PC_RANGE = (0.0, -5.12, -3.0, 10.24, 5.12, 1.0)  # 64 x 64 pillars of the KITTI size
ATOL = 1e-4
# the anchor curriculum as tests/test_anchor_path.py sets it (no shipped YAML turns it on)
LOSS_CURRICULUM = {"UCL": True, "HEIGHT": 1, "ELONGATION": -10, "OFFSET": 0, "FIXED": True,
                   "ALPHA": 0.01}
CURRICULUM_CFG = {"UCL": True, "ALPHA": 0.001, "ELONGATION": -10, "HEIGHT": 1, "OFFSET": 0,
                  "INV": False, "NORM": False, "POSW": 1, "START": 0, "END": 30}


def load(path):
    return cfg_from_yaml_file(str(REPO / path))


def t(a):
    return torch.from_numpy(np.array(a))


# anchors and the coder

@pytest.mark.parametrize("path,grid", [(KITTI_PP, (64, 64, 1)), (KITTI_PP, (432, 496, 1)),
                                       (WAYMO_PP, (40, 36, 1))])
def test_build_anchors_matches_jax_bitwise(path, grid):
    cfg = load(path)
    names = list(cfg.CLASS_NAMES)
    pr = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    want = jax_build_anchors(cfg.MODEL.DENSE_HEAD, names, grid, pr)
    got = build_anchors(cfg.MODEL.DENSE_HEAD, names, grid, pr)
    assert got[0].dtype == np.float32 and got[0].tobytes() == want[0].tobytes()
    assert len(got[1]) == len(want[1]) == 3
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
    # six anchors a cell, class-blocked: (size slot x rotations + rotation)
    h, w = grid[1] // 2, grid[0] // 2
    assert got[0].shape == (h * w * 6, 7)
    np.testing.assert_array_equal(got[1][1][:2], [2, 3])


@pytest.mark.parametrize("code_size,sincos", [(7, False), (7, True), (9, False), (9, True)])
def test_residual_coder_matches_jax(code_size, sincos):
    rng = np.random.RandomState(code_size + sincos)
    n = 200
    anchors = np.concatenate([rng.uniform(-40, 40, (n, 3)), rng.uniform(0.5, 5, (n, 3)),
                              rng.uniform(-np.pi, np.pi, (n, 1)),
                              rng.randn(n, code_size - 7)], -1).astype(np.float32)
    boxes = np.concatenate([anchors[:, :3] + rng.randn(n, 3), rng.uniform(0.3, 6, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1)),
                            rng.randn(n, code_size - 7)], -1).astype(np.float32)
    jc, pc = JaxCoder(code_size, sincos), ResidualCoder(code_size, sincos)
    assert pc.code_size == jc.code_size
    enc = pc.encode(t(boxes), t(anchors))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jc.encode(jnp.asarray(boxes),
                                                                jnp.asarray(anchors), xp=jnp)),
                               rtol=1e-6, atol=1e-6)
    dec = pc.decode(enc, t(anchors))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jc.decode(jnp.asarray(enc.numpy()),
                                                                jnp.asarray(anchors), xp=jnp)),
                               rtol=1e-6, atol=1e-6)


# assignment

def _seeded_gt(rng, b=2, m=12, real=7):
    gt = np.zeros((b, m, 8), np.float32)
    sizes = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)
    for i in range(b):
        cls = rng.randint(1, 4, real)
        gt[i, :real, 0] = rng.uniform(0.5, 9.5, real)
        gt[i, :real, 1] = rng.uniform(-4.5, 4.5, real)
        gt[i, :real, 2] = rng.uniform(-1.5, -0.5, real)
        gt[i, :real, 3:6] = sizes[cls - 1] * rng.uniform(0.9, 1.1, (real, 3))
        gt[i, :real, 6] = rng.uniform(-np.pi, np.pi, real)
        gt[i, :real, 7] = cls
    gt[1, 2, :] = gt[1, 1, :]  # a duplicate object: both GTs reach the same anchors
    return gt


def _assign_both(anchors, index, gt, groups, class_ids, matched, unmatched, code=7,
                 sincos=False):
    want = jassign.assign_anchor_targets(anchors, index, jnp.asarray(gt), jnp.asarray(groups),
                                         class_ids, matched, unmatched, JaxCoder(code, sincos))
    got = passign.assign_anchor_targets(t(anchors), [t(i).long() for i in index], t(gt),
                                        t(groups), class_ids, matched, unmatched,
                                        ResidualCoder(code, sincos))
    return got, want


def _check_targets(got, want):
    np.testing.assert_array_equal(got.box_cls_labels.numpy(), np.asarray(want.box_cls_labels))
    np.testing.assert_array_equal(got.groups.numpy(), np.asarray(want.groups))
    np.testing.assert_allclose(got.box_reg_targets.numpy(), np.asarray(want.box_reg_targets),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.reg_weights.numpy(), np.asarray(want.reg_weights),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sincos", [False, True])
def test_assign_anchor_targets_matches_jax(sincos):
    cfg = load(KITTI_PP)
    names = list(cfg.CLASS_NAMES)
    anchors, index, matched, unmatched, class_ids = build_anchors(cfg.MODEL.DENSE_HEAD, names,
                                                                  GRID, PC_RANGE)
    rng = np.random.RandomState(3)
    gt = _seeded_gt(rng)
    groups = rng.randint(1, 96, gt.shape[:2]).astype(np.int32) * (gt[..., 7] > 0)
    got, want = _assign_both(anchors, index, gt, groups, class_ids, matched, unmatched,
                             sincos=sincos)
    _check_targets(got, want)
    labels = got.box_cls_labels.numpy()
    assert (labels > 0).sum() >= 14 and (labels == -1).sum() > 0  # positives and ignored
    assert set(np.unique(got.groups.numpy()[labels > 0])) <= set(groups[groups > 0].tolist())


def test_assign_force_matches_ties_alike():
    """Two anchors at exactly equal IoU with one GT are both forced positive
    (their IoU 0.6 sits below no threshold here: matched 0.9); an anchor
    that is best for two GTs takes the first; a padded GT slot assigns
    nothing."""
    anchors = np.array([[0, 0, 0, 2, 1, 1, 0], [1, 0, 0, 2, 1, 1, 0], [5, 0, 0, 2, 1, 1, 0],
                        [8, 0, 0, 2, 1, 1, 0]], np.float32)
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [0.5, 0, 0, 2, 1, 1, 0, 1]   # halfway between anchors 0 and 1
    gt[0, 1] = [5.25, 0, 0, 2, 1, 1, 0, 1]  # anchor 2 is best for this GT and the next
    gt[0, 2] = [5.25, 0, 0, 2, 1, 1, 0, 1]
    groups = np.array([[3, 5, 9, 0]], np.int32)
    index = [np.arange(4, dtype=np.int32)]
    got, want = _assign_both(anchors, index, gt, groups, (1,), [0.9], [0.45])
    _check_targets(got, want)
    np.testing.assert_array_equal(got.box_cls_labels.numpy(), [[1, 1, 1, 0]])
    np.testing.assert_array_equal(got.groups.numpy(), [[3, 3, 5, 0]])


# losses

def _loss_inputs(rng, b=2, a=256, c=3):
    logits = rng.randn(b, a, c).astype(np.float32)
    target = np.zeros((b, a, c), np.float32)
    groups = np.zeros((b, a, c), np.int64)
    for i in range(b):
        pos = rng.choice(a, 40, replace=False)
        cls = rng.randint(0, c, 40)
        target[i, pos, cls] = 1.0
        groups[i, pos, cls] = rng.randint(1, 96, 40)
    weights = rng.rand(b, a).astype(np.float32)
    return logits, target, groups, weights


def test_plain_anchor_losses_match_jax():
    rng = np.random.RandomState(0)
    logits, target, groups, weights = _loss_inputs(rng)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        pl.sigmoid_focal_loss(t(logits), t(target), t(weights)).numpy(),
        np.asarray(jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(target),
                                         jnp.asarray(weights))), **close)
    pred, tgt = rng.randn(2, 64, 7).astype(np.float32), rng.randn(2, 64, 7).astype(np.float32)
    tgt[0, 3, 2] = np.nan
    tgt[1, 5, 0] = np.inf
    cw = [1.0, 1.0, 2.0, 1.0, 0.5, 1.0, 1.0]
    np.testing.assert_allclose(
        pl.weighted_smooth_l1(t(pred), t(tgt), t(weights[:, :64]), code_weights=cw).numpy(),
        np.asarray(jl.weighted_smooth_l1(jnp.asarray(pred), jnp.asarray(tgt),
                                         jnp.asarray(weights[:, :64]), code_weights=cw)), **close)
    one_hot = np.eye(2, dtype=np.float32)[rng.randint(0, 2, (2, 256))]
    dir_logits = rng.randn(2, 256, 2).astype(np.float32)
    np.testing.assert_allclose(
        pl.weighted_cross_entropy(t(dir_logits), t(one_hot), t(weights)).numpy(),
        np.asarray(jl.weighted_cross_entropy(jnp.asarray(dir_logits), jnp.asarray(one_hot),
                                             jnp.asarray(weights))), **close)
    sums, cnts = pl.anchor_group_confidences(torch.sigmoid(t(logits)), t(groups), 3)
    jsums, jcnts = jl.anchor_group_confidences(jax.nn.sigmoid(jnp.asarray(logits)),
                                               jnp.asarray(groups), 3)
    assert cnts.sum() == 80
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), **close)


def _jax_state(means, stds, inited):
    return jl.AnchorCurriculumState(jnp.asarray(means, jnp.float32),
                                    jnp.asarray(stds, jnp.float32), jnp.asarray(inited))


@pytest.mark.parametrize("name,cfg,epoch,start", [
    ("base", CURRICULUM_CFG, 7, None),
    ("sm", dict(CURRICULUM_CFG, SM=True, SME=5, SMT=0.5), 9, None),
    ("sma_norm_offset", dict(CURRICULUM_CFG, SMA=True, SME=5, SMT=0.5, NORM=True, OFFSET=0.5),
     9, None),
    ("ema_from_state", dict(CURRICULUM_CFG, NORM=True, OFFSET=0.3, ALPHA=0.1, OTO=True),
     3, ([0.3, 0.2, 0.1], [0.05, 0.1, 0.02], [True, False, True])),
    ("inverse", dict(CURRICULUM_CFG, INV=True, START=2, END=[5, 6, 7], CUT=20,
                         HEIGHT=[1.0, 0.5, 2.0]), 8, None),
])
def test_curriculum_focal_loss_matches_jax(name, cfg, epoch, start):
    """The configurations of tests/test_anchor_curriculum_vs_reference_torch.py
    (the base and the SM variant), and the SMA, NORM/OFFSET, OTO, INV
    and per-class HEIGHT/END branches, the new state compared too."""
    rng = np.random.RandomState(1 if name == "sm" else 0)
    logits, target, groups, weights = _loss_inputs(rng)
    if cfg.get("SMA"):  # SMA weighs positives without a group
        groups[:, ::2] = 0
    state = (pl.AnchorCurriculumState(*(torch.tensor(v) for v in start)) if start
             else pl.AnchorCurriculumState.create(3))
    jstate = _jax_state(*start) if start else jl.AnchorCurriculumState.create(3)
    loss, cw, new, (s, c) = pl.curriculum_sigmoid_focal_loss(t(logits), t(target), t(weights),
                                                             t(groups), state, cfg, epoch)
    jloss, jcw, jnew, (js, jc) = jl.curriculum_sigmoid_focal_loss(
        jnp.asarray(logits), jnp.asarray(target), jnp.asarray(weights), jnp.asarray(groups),
        jstate, cfg, epoch)
    close = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), **close)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **close)
    for f in ("means", "stds"):
        np.testing.assert_allclose(getattr(new, f).numpy(), np.asarray(getattr(jnew, f)), **close)
    np.testing.assert_array_equal(new.initialized.numpy(), np.asarray(jnew.initialized))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **close)
    assert float((cw != 1).sum()) > 0  # the curriculum weighted something


# the slice: KITTI PointPillars at a 64x64 grid

def scene_batch(rng, b=2, n=8192):
    """Points over the 64 x 64 pillars (most pillars hold some), 4 features."""
    pts = np.concatenate([rng.uniform(PC_RANGE[0], PC_RANGE[3], (b, n, 1)),
                          rng.uniform(PC_RANGE[1], PC_RANGE[4], (b, n, 1)),
                          rng.uniform(-2.8, 0.8, (b, n, 1)), rng.rand(b, n, 1)],
                         -1).astype(np.float32)
    return {"points": pts, "points_mask": np.ones((b, n), bool)}


def small_kitti_cfg():
    cfg = load(KITTI_PP)
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 512
    return cfg


def jax_variables(cfg, meta, host, seed):
    jnet = jax_build_network(cfg.MODEL, meta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in ("points", "points_mask")}, train=False)
    variables = perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=seed)
    # class logits around 0, so that scores spread over (0, 1) rather than
    # sit at the prior; box residuals small, as pcdet's conv_box init (std
    # 0.001) makes them, so that decoded boxes stay near their anchors
    head = variables["params"]["AnchorHeadSingle_0"]
    head["conv_cls"]["bias"] = head["conv_cls"]["bias"] + np.float32(4.0)
    head["conv_box"]["kernel"] = head["conv_box"]["kernel"] * np.float32(0.02)
    return jnet, variables


# what raises

def test_unported_anchor_pieces_raise_by_name():
    """ATSS raises by name; ``AnchorHeadMulti``, which raised until it was
    ported, builds (``test_torch_port_kitti_model.py`` holds it to flax)."""
    from com_tpu_torch.models.dense_heads.anchor_head import AnchorHeadMulti
    from com_tpu_torch.utils.registry import DENSE_HEADS

    cfg = load("configs/kitti_models/second_multihead.yaml").MODEL.DENSE_HEAD
    assert isinstance(DENSE_HEADS.get("AnchorHeadMulti")(cfg, 64, 3, ("Car", "Pedestrian",
                                                                      "Cyclist")),
                      AnchorHeadMulti)
    with pytest.raises(NotImplementedError, match="ATSSTargetAssigner"):
        passign.atss_assign_targets(torch.zeros(4, 7), torch.zeros(1, 2, 8), topk=9,
                                    box_coder=ResidualCoder())


def test_waymo_pointpillar_grid_fails_alike():
    """``configs/waymo_models/pointpillar.yaml`` at a grid whose third
    stride-2 stage rounds up (36 -> 18 -> 9 -> 5): the x4 deblock gives 20
    against 18, and both packages fail on the concatenation of the
    upsampled maps; neither crops."""
    cfg = load(WAYMO_PP)
    names = list(cfg.CLASS_NAMES)
    grid, vsize = (36, 36, 1), (0.32, 0.32, 6.0)
    pr = (-5.76, -5.76, -2.0, 5.76, 5.76, 4.0)
    host = scene_batch(np.random.RandomState(0), n=512)
    host["points"] = np.concatenate([host["points"][..., :3] - [[[5.12, 0, 0]]],
                                     host["points"][..., 3:], host["points"][..., 3:]],
                                    -1).astype(np.float32)
    jnet = jax_build_network(cfg.MODEL, JaxMeta(names, pr, vsize, grid, 5))
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(lambda b: jnet.init(jax.random.PRNGKey(0), b, train=False),
                       {k: jnp.asarray(v) for k, v in host.items()})
    net = build_network(cfg.MODEL, DatasetMeta(names, pr, vsize, grid, 5), device="cpu")
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        with torch.no_grad():
            net({k: torch.from_numpy(v) for k, v in host.items()})
