"""MPPNet (the multi-frame second stage over a first stage's stored boxes)
against the JAX package on the CPU: ``generate_trajectory`` (the validity
exactly, the rows to 1e-5); ``sample_mppnet_targets`` with and without
SAMPLE_ROI_BY_EACH_CLASS, and on a sparse frame whose backgrounds backfill
the foreground quota (the selected proposals, labels and foreground mask
exactly; the canonical and world GT and the soft labels to 1e-5);
``mppnet_loss`` with and without the corner loss (total and parts to
1e-5, the gradient with respect to every prediction to 1e-4); the
``MPPNet`` detector's eval step against ``com_tpu``'s (``mppnet_4frames.
yaml`` narrowed as ``chip_smoke.mppnet_small_case``, the weights carried
by the bridge, f32 to 1e-4) and its train-mode targets; the port's loss
falling on a repeated batch; the chunked point crop against the
unchunked; the census of the COM configs' samplers and confidence shapes;
the train step and CLIs raising for MPPNet by name.  Inputs:
``chip_smoke.mppnet_sequence`` from a seed (objects moving a frame,
jittered proposals among background boxes, shuffled a frame).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import mppnet_sequence, mppnet_small_case
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.models.mppnet import generate_trajectory as jax_generate_trajectory
from com_tpu.models.mppnet import mppnet_loss as jax_mppnet_loss
from com_tpu.models.mppnet import sample_mppnet_targets as jax_sample_mppnet_targets
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.models.mppnet import (MPPNetTargets, generate_trajectory, mppnet_loss,
                                         sample_mppnet_targets)
from com_tpu_torch.models.mppnet.mppnet_head import crop_trajectory_points
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import _match
from torch_port_centerhead_setup import flax_variables

torch.set_num_threads(2)
ATOL = 1e-4
RANGE = (-12.8, -12.8, -2.0, 12.8, 12.8, 4.0)
LOSS_CFG = {"CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 2.0, "traj_reg_weight": [2.0, 1.5, 3.0],
                             "code_weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5]}}


def t(a):
    return torch.from_numpy(np.array(a))


def sequence(seed, sparse=False):
    """4 frames of 40 proposals a sample over 6 moving objects (2 scenes,
    1,000 points a frame); the proposals carry their own index + 1 in a
    10th column, so that a sampled trajectory names its proposal.  With
    ``sparse`` the last 28 rows of frame 0 are zero (padding): fewer
    foregrounds than a quota of 8, and fewer proposals than 16 RoIs."""
    s = mppnet_sequence(np.random.RandomState(seed), 2, 1000, 4, RANGE, proposals=40,
                        objects=6, copies=4, m=12)
    boxes = s["roi_boxes"]
    idx = np.broadcast_to(np.arange(1, 41, dtype=np.float32)[None, None, :, None],
                          (*boxes.shape[:3], 1))
    s["roi_boxes"] = np.concatenate([boxes, idx], -1)
    if sparse:
        s["roi_boxes"][:, 0, 12:] = 0
        s["roi_scores"][:, 0, 12:] = 0
    return s


def test_generate_trajectory_matches_jax():
    """The linked rows of every frame to 1e-5 (they are copies of the
    proposals), the validity exactly; some (RoI, frame) pairs link and
    some do not."""
    s = sequence(3)
    props = s["roi_boxes"]
    jtraj, jvalid = jax.jit(jax_generate_trajectory)(props[:, 0], props)
    traj, valid = generate_trajectory(t(props[:, 0]), t(props))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-5, atol=1e-5)
    linked = valid[:, 1:].numpy()
    assert 0 < linked.mean() < 1


@pytest.mark.parametrize("by_class,sparse", [(True, False), (False, False), (True, True)])
def test_sample_mppnet_targets_matches_jax(by_class, sparse):
    """96 -> 16 RoIs a sample (a foreground quota of 8): the proposals
    sampled (their index column), the labels, scores, trajectories,
    validity and foreground mask exactly; the canonical and world GT and
    the soft class labels to 1e-5.  The last 16 proposals' scores are
    rounded to 0.1, so that the stable order decides among ties.  Sparse:
    the quota is not met and backgrounds fill the slots, then padding
    (label -1)."""
    s = sequence(5, sparse)
    scores = s["roi_scores"].copy()
    scores[..., 24:] = np.round(scores[..., 24:], 1)  # ties
    props = s["roi_boxes"]
    traj, valid = generate_trajectory(t(props[:, 0]), t(props))
    args = (traj.numpy(), valid.numpy(), scores[:, 0], s["roi_labels"], s["gt_boxes"])
    kw = dict(roi_per_image=16, sample_by_class=by_class)
    want = jax.jit(lambda *a: jax_sample_mppnet_targets(*a, **kw))(*args)
    got = sample_mppnet_targets(*(t(a) for a in args), **kw)
    assert isinstance(got, MPPNetTargets)
    for k in ("trajectory_rois", "valid_length", "rois", "roi_scores", "roi_labels",
              "reg_valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("gt_of_rois_ct", "gt_of_rois_src", "cls_labels"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    fg = got.reg_valid.numpy()
    picked = got.trajectory_rois[:, 0, :, 9].numpy()
    assert (picked[fg] > 0).all() and fg.any()
    if sparse:
        assert (fg.sum(1) < 8).all() and (got.cls_labels.numpy() == -1).any()
        assert ((picked > 0) & ~fg).any()  # backgrounds backfill the quota
    else:
        assert (fg.sum(1) == 8).all()


@pytest.mark.parametrize("corner", [True, False])
def test_mppnet_loss_matches_jax(corner):
    """Seeded predictions (3 layers, 4 groups) against targets sampled from
    a sequence: the total and each part to 1e-5, the gradient of the total
    with respect to every prediction to 1e-4."""
    s = sequence(7)
    props = s["roi_boxes"][..., :9]
    traj, valid = generate_trajectory(t(props[:, 0]), t(props))
    tg = sample_mppnet_targets(traj, valid, t(s["roi_scores"][:, 0]), t(s["roi_labels"]),
                               t(s["gt_boxes"]), roi_per_image=16)
    targets = {k: getattr(tg, k).numpy() for k in ("rois", "gt_of_rois_ct", "gt_of_rois_src",
                                                   "cls_labels", "reg_valid")}
    rng = np.random.RandomState(8)
    br = 32
    preds = {"rcnn_cls": rng.randn(3, br, 1), "rcnn_reg": 0.3 * rng.randn(br, 7),
             "point_reg": 0.3 * rng.randn(12, br, 7), "box_reg": 0.3 * rng.randn(br, 7)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    cfg = dict(copy.deepcopy(LOSS_CFG), CORNER_LOSS_REGULARIZATION=corner)

    def jloss(p):
        return jax_mppnet_loss(p, {k: jnp.asarray(v) for k, v in targets.items()}, cfg)

    (jtotal, jparts), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(preds)
    tp = {k: t(v).requires_grad_(True) for k, v in preds.items()}
    total, parts = mppnet_loss(tp, {k: t(v) for k, v in targets.items()}, cfg)
    total.backward()
    parts = {k: float(v.detach()) for k, v in parts.items()}
    assert targets["reg_valid"].sum() > 0 and (parts["rcnn_loss_corner"] > 0) == corner
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5, atol=1e-6)
    for k, v in jparts.items():
        np.testing.assert_allclose(parts[k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad[k]), rtol=ATOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def mppnet():
    """``chip_smoke.mppnet_small_case`` (``mppnet_4frames.yaml`` narrowed,
    48 proposals a frame over 6 objects): the port's seeded init with its
    norms' running statistics moved, carried to flax by the bridge's rules
    backwards and back into the port by ``load_jax_variables`` (the
    detector's top-level ``roi_head`` scope); the JAX detector."""
    cfg, pmeta, batch = mppnet_small_case()
    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, pmeta, device="cpu", seed=9)
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if "running" in name:
                buf.copy_(torch.rand(buf.shape, generator=gen)
                          + (0.5 if "var" in name else -0.5))
    variables = flax_variables(net, cfg, ("roi_head",))
    load_jax_variables(net, variables, cfg.MODEL, names)
    jmeta = JaxMeta(names, pmeta.point_cloud_range, pmeta.voxel_size, pmeta.grid_size,
                    pmeta.num_point_features)
    jnet = jax_build_network(copy.deepcopy(cfg.MODEL), jmeta)
    inputs = {k: batch[k] for k in ("roi_boxes", "roi_scores", "roi_labels", "points",
                                    "points_mask")}
    for k in ("roi_boxes", "roi_scores"):  # zero-padded proposal slots, as a short frame's
        inputs[k] = inputs[k].copy()
        inputs[k][:, :, 40:] = 0
    inputs["roi_labels"] = np.where(np.arange(48) < 40, inputs["roi_labels"], 0).astype(np.int32)
    return cfg, pmeta, jmeta, net, jnet, variables, inputs, batch


def test_mppnet_eval_step_matches_jax(mppnet):
    """``make_eval_step`` (the forward, sigmoid of the head's class logits,
    SCORE_THRESH 0.1, NMS at 0.7 over every RoI, post-max 500) against
    ``com_tpu``'s eval step on the same weights: the valid slots exactly,
    each detection (box, score, label) within 1e-4 of its nearest, one to
    one; the forward's trajectories exactly and its boxes and logits to
    1e-4.  The last 8 proposal slots a frame are zero: neither package
    writes ``roi_valid`` for MPPNet, so such a slot may surface with label
    0 in both (kept from ``com_tpu``)."""
    cfg, pmeta, jmeta, net, jnet, variables, inputs, _ = mppnet
    names = list(cfg.CLASS_NAMES)
    jstep = jax_make_eval_step(jnet, cfg.MODEL, names, jmeta)
    jdet = [np.asarray(a) for a in jax.jit(jstep)(variables, inputs)]
    step = make_eval_step(net, cfg.MODEL, names, pmeta, device="cpu")
    det = [g.numpy() for g in step(inputs)]
    jb, js, jl, jv = jdet
    boxes, scores, labels, valid = det
    assert boxes.shape == jb.shape == (2, 48, 7)
    np.testing.assert_array_equal(valid, jv)
    assert 10 < valid.sum() < valid.size  # some suppressed, many kept
    assert ((labels == 0) & valid).any() and ((jl == 0) & jv).any()
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        got, want = rows(boxes, scores, labels, valid), rows(jb, js, jl, jv)
        real, jreal = got[:, -1] > 0, want[:, -1] > 0
        worst, one_to_one = _match(got[real], want[jreal])
        assert worst <= ATOL and one_to_one
        # the padded slots decode to one box each, repeated: nearest, not one to one
        assert (~real).sum() == (~jreal).sum()
        if (~real).any():
            assert _match(got[~real], want[~jreal])[0] <= ATOL
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(variables, inputs)
    with torch.no_grad():
        out = net({k: t(v) for k, v in inputs.items()})
    np.testing.assert_array_equal(out["trajectory_rois"].numpy(),
                                  np.asarray(jout["trajectory_rois"]))
    np.testing.assert_array_equal(out["valid_length"].numpy(), np.asarray(jout["valid_length"]))
    assert 0 < out["valid_length"][:, 1:].mean() < 1
    for k in ("batch_box_preds", "batch_cls_preds"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=ATOL, atol=ATOL,
                                   err_msg=k)


def test_mppnet_train_mode_matches_jax(mppnet):
    """The detector in train mode with GT (dropout 0, so neither package
    draws): ``batch["mppnet_targets"]`` as the JAX detector's (the sampled
    trajectories, labels and foreground mask exactly, the GT and soft
    labels to 1e-5), the head's train-mode predictions (its norms on the
    batch's statistics) and ``mppnet_loss`` over them to 1e-4."""
    cfg, _, _, net, jnet, variables, inputs, batch = mppnet
    train_in = dict(inputs, gt_boxes=batch["gt_boxes"])
    jout, _ = jax.jit(lambda v, b: jnet.apply(v, b, train=True, mutable=["batch_stats"]))(
        variables, train_in)
    net.train()
    try:
        out = net({k: t(v) for k, v in train_in.items()})
    finally:
        net.eval()
    got, want = out["mppnet_targets"], jout["mppnet_targets"]
    for k in ("trajectory_rois", "valid_length", "rois", "roi_labels", "reg_valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    for k in ("gt_of_rois_ct", "gt_of_rois_src", "cls_labels"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got.reg_valid.sum() > 0 and got.trajectory_rois.shape == (2, 4, 16, 9)
    for k in ("rcnn_cls", "rcnn_reg", "point_reg", "box_reg"):
        np.testing.assert_allclose(out["mppnet_preds"][k].detach().numpy(),
                                   np.asarray(jout["mppnet_preds"][k]), rtol=ATOL, atol=ATOL,
                                   err_msg=k)
    loss_cfg = cfg.MODEL.ROI_HEAD.LOSS_CONFIG
    total, _ = mppnet_loss(out["mppnet_preds"], got, loss_cfg)
    jtotal, _ = jax_mppnet_loss(jout["mppnet_preds"], jout["mppnet_targets"]._asdict(), loss_cfg)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=ATOL)


def test_mppnet_loss_falls_on_a_repeated_batch():
    """The port alone, function-level training as MPPNet trains in either
    package: the detector in train mode (targets sampled), ``mppnet_loss``,
    backward and ``AdamOneCycle`` (``build_optimizer``, the YAML's
    schedule over 20 steps), 20 steps on one batch: the loss ends below 0.8
    of its first value, every value finite."""
    from com_tpu_torch.train.optim import build_optimizer

    cfg, meta, batch = mppnet_small_case(seed=3)
    net = build_network(cfg.MODEL, meta, device="cpu", seed=4).train()
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 20, 20)
    inputs = {k: t(batch[k]) for k in ("roi_boxes", "roi_scores", "roi_labels", "points",
                                       "points_mask", "gt_boxes")}
    losses = []
    for _ in range(20):
        out = net(dict(inputs))
        loss, _ = mppnet_loss(out["mppnet_preds"], out["mppnet_targets"],
                              cfg.MODEL.ROI_HEAD.LOSS_CONFIG)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], losses[::4]


def test_crop_in_blocks_is_the_unblocked_crop(monkeypatch):
    """The point crop with its RoIs in blocks of 3 (``CROP_BLOCK``) equals
    the crop in one block, bitwise."""
    from com_tpu_torch.models.mppnet import mppnet_head

    s = sequence(11)
    props = t(s["roi_boxes"][..., :9])
    traj, valid = generate_trajectory(props[:, 0], props)
    pts, mask = t(s["points"]), t(s["points_mask"])
    n = pts.shape[0] * pts.shape[1]
    monkeypatch.setattr(mppnet_head, "CROP_BLOCK", n * 1000)
    whole = crop_trajectory_points(pts, mask, traj, valid, 16)
    monkeypatch.setattr(mppnet_head, "CROP_BLOCK", 3 * n)
    blocked = crop_trajectory_points(pts, mask, traj, valid, 16)
    assert torch.equal(whole, blocked) and float(whole.abs().sum()) > 0


@pytest.mark.parametrize("which,conf", [("car_com2", (1, 96)), ("ped_com", (1, 15)),
                                        ("ped_com2", (1, 15))])
def test_com_configs_sampler_and_confidence_shape(which, conf):
    """The paper's single-class COM configs: both packages build the same
    GT sampler class from the YAML's gt_sampling (``COM: True``:
    DataBaseSamplerCOM2) and the same curriculum confidence shape
    (``conf_shape_for``)."""
    from com_tpu.data.augmentor.database_sampler import build_gt_sampler as jax_build_sampler
    from com_tpu.train.step import conf_shape_for as jax_conf_shape_for
    from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg
    from com_tpu_torch.data.augmentor.database_sampler import build_gt_sampler
    from com_tpu_torch.train.step import conf_shape_for
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    path = f"configs/waymo_models/com/centerpoint_pillar_{which}.yaml"
    cfg, jcfg = cfg_from_yaml_file(path), jax_cfg(path)

    def sampler_cfg(c):
        return next(a for a in c.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST
                    if a.NAME == "gt_sampling")

    names = list(cfg.CLASS_NAMES)
    ours = build_gt_sampler(None, sampler_cfg(cfg), names, db_infos={})
    theirs = jax_build_sampler(None, sampler_cfg(jcfg), list(jcfg.CLASS_NAMES), db_infos={})
    assert type(ours).__name__ == type(theirs).__name__ == "DataBaseSamplerCOM2"
    assert conf_shape_for(cfg.MODEL, names) == jax_conf_shape_for(jcfg.MODEL, names) == conf


def test_mppnet_train_step_and_clis_raise_by_name(tmp_path):
    """``make_train_step`` and the train and test CLIs raise for MPPNet with
    the reason; ``com_tpu``'s eval step fails on a batch without
    ``roi_boxes`` (what its CLIs' datasets give), so its CLIs cannot run
    MPPNet either.  Without ``device`` the entry points ask for the card."""
    from com_tpu_torch.tools import test as test_cli
    from com_tpu_torch.tools import train as train_cli
    from com_tpu_torch.train.step import make_train_step

    cfg, meta, batch = mppnet_small_case()
    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="MPPNet.*mppnet_loss.*roi_boxes"):
        make_train_step(net, cfg.MODEL, names, meta, None, None, device="cpu")
    argv = ["--cfg_file", "configs/waymo_models/mppnet_4frames.yaml", "--device", "cpu",
            "--output_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="train CLI for MPPNet.*roi_boxes"):
        train_cli.main(argv)
    with pytest.raises(NotImplementedError, match="test CLI for MPPNet.*roi_boxes"):
        test_cli.main(argv + ["--ckpt", str(tmp_path / "none.pth")])
    jmeta = JaxMeta(names, meta.point_cloud_range, meta.voxel_size, meta.grid_size, 6)
    jnet = jax_build_network(copy.deepcopy(cfg.MODEL), jmeta)
    jstep = jax_make_eval_step(jnet, cfg.MODEL, names, jmeta)
    with pytest.raises(KeyError, match="roi_boxes"):
        jstep({}, {"points": batch["points"], "points_mask": batch["points_mask"]})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_network(cfg.MODEL, meta)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_eval_step(net, cfg.MODEL, names, meta)
    assert isinstance(meta, DatasetMeta)


def test_mppnet_16frames_shipped_widths_fail_in_both():
    """``mppnet_16frames.yaml`` keeps the 4-frame pool MLPS ([[128, 128],
    [128, 128]]) with TRANS_INPUT 64: the pooled geometry (2 x 128 wide)
    cannot add to the motion features (64 wide), so the head's forward
    fails in ``com_tpu`` and in the port alike (kept: the YAML is not
    edited; here with 16 points a RoI and a 2^3 grid).  With the pool's last widths summing to TRANS_INPUT
    (``chip_smoke.R_MPP16_MLPS``) the port runs it."""
    from chip_smoke import R_MPP16_MLPS
    from com_tpu.models.mppnet import MPPNetHead as JaxMPPNetHead
    from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg
    from com_tpu_torch.models.mppnet import MPPNetHead
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    path = "configs/waymo_models/mppnet_16frames.yaml"
    rng = np.random.RandomState(0)
    traj = np.zeros((1, 16, 2, 9), np.float32)
    traj[..., 3:6] = 2.0
    batch = {"trajectory_rois": traj, "valid_length": np.ones((1, 16, 2), np.float32),
             "points": rng.randn(1, 200, 6).astype(np.float32),
             "points_mask": np.ones((1, 200), bool)}

    def shrink(head_cfg):  # fewer points and proxies: the widths that clash stay
        head_cfg.ROI_GRID_POOL.GRID_SIZE = 2
        head_cfg.Transformer.update(num_lidar_points=16, num_proxy_points=8)
        return head_cfg

    jhead = JaxMPPNetHead(model_cfg=shrink(jax_cfg(path).MODEL.ROI_HEAD), num_class=1)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jax.jit(lambda k, b: jhead.init(k, b, train=False))(jax.random.PRNGKey(0), batch)
    cfg = shrink(cfg_from_yaml_file(path).MODEL.ROI_HEAD)
    torch.manual_seed(0)
    with torch.no_grad(), pytest.raises(RuntimeError, match="must match"):
        MPPNetHead(cfg).eval()({k: t(v) for k, v in batch.items()})
    cfg.ROI_GRID_POOL.MLPS = R_MPP16_MLPS
    with torch.no_grad():
        out = MPPNetHead(cfg).eval()({k: t(v) for k, v in batch.items()})
    assert out["batch_box_preds"].shape == (1, 2, 7)
