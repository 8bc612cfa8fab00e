"""PointRCNN in training, through both packages on the CPU (setup:
``tests/torch_port_pointrcnn_setup.py``, the empty GT slots on the model's
own proposals): ``point_head_box_loss``; one train step (deterministic RoI
sampling), its loss and every term (``point_loss_cls``, ``point_loss_box``,
``rcnn_loss_cls``, ``rcnn_loss_reg``, ``rcnn_loss_corner``) to 1e-5, the
running statistics and the parameters after the optax update to the
train-step tests' tolerances (``test_torch_port_train_common``), every
gradient to those or to the JAX step's own f32 reproducibility, whichever
is larger (one JAX jit of the loss and its gradient, called twice); the
loss falling over 8 steps, as
``tests/test_pointrcnn.py`` shows for the JAX step.  And the behaviours
the port keeps from the JAX package: neither package's train and test
CLIs run PointRCNN; RCNN_CLS's soft IoU labels whatever CLS_SCORE_TYPE.
"""
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.dense_heads.point_head import point_head_box_loss as jax_point_head_box_loss
from com_tpu.models.roi_heads.roi_targets import assign_roi_targets as jax_assign_roi_targets
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu.utils.config import CfgNode as JaxCfgNode
from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from com_tpu_torch.models.dense_heads.point_head import point_head_box_loss
from com_tpu_torch.models.roi_heads.roi_targets import assign_roi_targets
from com_tpu_torch.tools import test, train
from com_tpu_torch.tools.kitti_tree import write_kitti_tree
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.config import cfg_from_yaml_file
from com_tpu_torch.utils.jax_weights import params_from_jax, state_dict_from_jax
import test_torch_port_train_common as common
from torch_port_kitti_setup import REPO
from torch_port_pointrcnn_setup import proposal_gt, setup

torch.set_num_threads(2)

TERMS = {"point_loss_cls", "point_loss_box", "rcnn_loss_cls", "rcnn_loss_reg",
         "rcnn_loss_corner"}
FORWARD_KEYS = ("point_features", "point_cls_preds", "point_box_preds_raw", "rcnn_cls",
                "rcnn_reg")


SWAP = [1, 0]  # the scenes in the other order: the same step in other f32 sums


def run_pair(seed):
    """Both packages' loss and gradients of one step (deterministic RoI
    sampling, so that the step is the same with the scenes swapped), the
    JAX step once more on the swapped batch, and the port's Adam update."""
    cfg, jmeta, pmeta, jnet, variables, net, host = setup(seed=seed)
    host = proposal_gt(net, host)
    names = list(cfg.CLASS_NAMES)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        roi_loss, tb = jax_compute_roi_loss(out, cfg.MODEL)
        p_loss, p_tb = jax_point_head_box_loss(out, cfg.MODEL.POINT_HEAD)
        tb.update(p_tb)
        fwd = {k: out[k] for k in FORWARD_KEYS + ("point_coords", "point_valid")}
        return (jnp.zeros(()) + roi_loss + p_loss,
                (mut["batch_stats"], tb, out["roi_targets"].reg_valid, fwd))

    step_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, (jbs, jtb, jfg, jfwd)), jgrads = step_fn(variables["params"],
                                                     variables["batch_stats"], host)
    (_, (_, _, _, sfwd)), sgrads = step_fn(variables["params"], variables["batch_stats"],
                                           {k: v[SWAP] for k, v in host.items()})
    jtx, _ = jax_build_optimizer(variables["params"], JaxCfgNode(dict(cfg.OPTIMIZATION)),
                                 100, 10)
    updates, _ = jtx.update(jgrads, jtx.init(variables["params"]), variables["params"])
    jparams = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b), variables["params"], updates)

    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    captured = {}
    hook = net.roi_head.register_forward_hook(lambda m, args, out: captured.update(out))
    loss, new_cur, aux, tb = step.loss_fn(state, host, 0)
    hook.remove()
    loss.backward()
    opt.step()
    return dict(
        cfg=cfg, meta=pmeta, host=host, state=state, new_cur=new_cur, aux=aux,
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_fg=np.asarray(jfg), jax_fwd={k: np.asarray(v) for k, v in jfwd.items()},
        swapped_fwd={k: np.asarray(sfwd[k])[SWAP] for k in FORWARD_KEYS},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        swapped_grads=params_from_jax(sgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        jax_params=params_from_jax(jparams, cfg.MODEL, names),
        fwd={k: captured[k].detach().numpy() for k in FORWARD_KEYS},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        params={k: q.detach().numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k})


def step_tolerance_ratio(grads, want):
    """The worst |grads - want| over ``check_grads``' step tolerance (rtol
    1e-4, atol 1e-6 of the tensor's max |g| + 1e-5 of the net's)."""
    gmax = max(np.abs(v).max() for v in want.values())
    return max(float((np.abs(grads[k] - w) / (1e-4 * np.abs(w) + 1e-6 * np.abs(w).max()
                                               + 1e-5 * gmax)).max()) for k, w in want.items())


@pytest.fixture(scope="module")
def pair():
    return run_pair(71)


def test_point_head_box_loss_matches_jax(pair):
    """On the JAX step's points and predictions, some points made invalid:
    the foreground targets (in-box classes, the enlarged band ignored), the
    focal class term and the smooth-L1 box term to 1e-6."""
    r = pair
    fwd = dict(r["jax_fwd"])
    fwd["point_valid"] = fwd["point_valid"].copy()
    fwd["point_valid"][:, ::5] = False
    batch = {k: fwd[k] for k in ("point_cls_preds", "point_box_preds_raw", "point_coords",
                                 "point_valid")}
    batch["gt_boxes"] = r["host"]["gt_boxes"]
    ph = r["cfg"].MODEL.POINT_HEAD
    want, want_tb = jax.jit(lambda b: jax_point_head_box_loss(b, ph))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_tb = point_head_box_loss({k: torch.from_numpy(np.array(v))
                                       for k, v in batch.items()}, ph)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for k in ("point_loss_cls", "point_loss_box"):
        assert float(want_tb[k]) > 0, k
        assert abs(float(got_tb[k]) - float(want_tb[k])) <= 1e-6 * float(want_tb[k]), k


def test_train_step_matches_jax(pair):
    """The train-mode forward, the loss and its terms, every gradient (the
    backbone's SA and FP blocks, both point-head branches, the RoI head),
    the running statistics, and the parameters after Adam; the curriculum
    carried unchanged and the confidence sums of (3, 1) zeros.

    The loss and terms are held to 1e-5, the statistics and the parameters
    to the step tolerances.  This model's f32 step is not reproducible at
    the step tolerances of the gradients and of the forward (1e-4): the JAX
    step itself, on the same batch with its two scenes swapped (the same
    math in other f32 sums), moves its gradients by 7-95x that tolerance
    (seeds 61, 71, 73; near-ties of the max pools and the masked norms'
    E[x^2] - E[x]^2 over few rows, flipped by rounding).  So the forward
    and the gradients are held to the larger of the step tolerance and the
    JAX step's own difference under the swap."""
    r = pair
    for k in FORWARD_KEYS:
        own = np.abs(r["swapped_fwd"][k] - r["jax_fwd"][k])
        np.testing.assert_array_less(np.abs(r["fwd"][k] - r["jax_fwd"][k]),
                                     np.maximum(1e-4 + 1e-4 * np.abs(r["jax_fwd"][k]),
                                                own.max()) + 1e-12, err_msg=k)
    assert set(r["tb"]) == set(r["jax_tb"]) == TERMS
    assert r["jax_fg"].sum() > 0 and r["tb"]["rcnn_loss_reg"] > 0
    common.check_loss_and_tb(dict(r, metrics={"loss": r["loss"]}))
    for prefix in ("backbone_3d.SA_modules.1.mlps.1.", "backbone_3d.FP_modules.0.",
                   "point_head.cls_layers.", "point_head.box_layers.", "roi_head.SA_modules.1.",
                   "roi_head.xyz_up_layer."):
        assert any(k.startswith(prefix) for k in r["grads"]), prefix
    assert set(r["grads"]) == set(r["jax_grads"])
    own = step_tolerance_ratio(r["swapped_grads"], r["jax_grads"])
    assert step_tolerance_ratio(r["grads"], r["jax_grads"]) <= max(1.0, own), own
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    common.check_params_after_step(r)
    assert r["new_cur"] is r["state"].curriculum
    assert r["aux"][0].confidence_sum.shape == (3, 1) and not r["aux"][0].confidence_sum.any()


def test_loss_falls_over_eight_steps(pair):
    """``train_step`` 8 times on the step test's batch from the port's own
    seeded weights: every term finite, the loss lower at the end (the JAX
    test's check)."""
    from com_tpu_torch.models.detectors import build_network

    cfg, pmeta, host = pair["cfg"], pair["meta"], pair["host"]
    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, pmeta, device="cpu", seed=3)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 200, 20)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    losses = []
    for _ in range(8):
        state, metrics = step(state, host, 0)
        assert TERMS <= set(metrics)
        assert all(np.isfinite(float(metrics[k])) for k in TERMS)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert state.step == 8


def test_clis_cannot_run_pointrcnn_in_either_package(tmp_path, monkeypatch):
    """Kept from com_tpu: its train CLI initialises the model from
    ``device_batch_keys``, which give PointRCNN no points (KeyError
    "points"), and its test CLI reads ``MODEL.DENSE_HEAD``, which PointRCNN
    has not; the port's train and test CLIs raise NotImplementedError by
    name instead of running it."""
    # the JAX CLI's global batch is the batch x the devices (8 in these
    # tests): 8 train frames make one batch of 1
    write_kitti_tree(tmp_path / "kitti", seed=0, num_train=8, num_val=1, num_points=2000)
    yaml = str(REPO / "configs/kitti_models/pointrcnn.yaml")
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tmp_path / "kitti")]
    monkeypatch.setattr(sys, "argv", ["train.py", "--cfg_file", yaml, "--workers", "1",
                                      "--epochs", "1", "--batch_size", "1", "--output_dir",
                                      str(tmp_path / "jax")] + data)
    with pytest.raises(KeyError, match="points"):
        runpy.run_path(str(REPO / "tools/train.py"), run_name="__main__")
    jcfg = jax_cfg_from_yaml_file(yaml)
    assert "DENSE_HEAD" not in jcfg.MODEL
    with pytest.raises(AttributeError, match="DENSE_HEAD"):
        jcfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD  # tools/test.py's EvalContext reads it
    base = ["--cfg_file", yaml, "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "port")] + data
    with pytest.raises(NotImplementedError, match="DENSE_HEAD.*PointRCNN"):
        train.main(base + ["--epochs", "1"])
    with pytest.raises(NotImplementedError, match="DENSE_HEAD.*PointRCNN"):
        test.main(base + ["--ckpt", str(tmp_path / "none.pth")])


@pytest.mark.parametrize("config", ["pointrcnn.yaml", "pointrcnn_iou.yaml"])
def test_cls_score_type_is_read_by_no_code(config):
    """Kept from com_tpu: no code of either package reads
    TARGET_CONFIG.CLS_SCORE_TYPE, so ``pointrcnn.yaml``'s "cls" trains on the
    same IoU-derived soft labels as ``pointrcnn_iou.yaml``'s "roi_iou":
    both packages' RoI targets at each YAML's thresholds hold soft labels
    strictly between 0 and 1 for RoIs between them, and agree."""
    read = re.compile(r"[\"'.]CLS_SCORE_TYPE")  # a key or an attribute; comments may name it
    for pkg in ("com_tpu", "com_tpu_torch"):
        for path in (REPO / pkg).rglob("*.py"):
            assert not read.search(path.read_text()), path
    tc = cfg_from_yaml_file(str(REPO / "configs/kitti_models" / config)).MODEL.ROI_HEAD
    tc = tc.TARGET_CONFIG
    lo, hi = float(tc.CLS_BG_THRESH), float(tc.CLS_FG_THRESH)
    gt = np.zeros((1, 2, 8), np.float32)
    gt[0, 0] = [0, 0, 0, 4, 2, 1.5, 0, 1]
    # RoIs shifted along x: IoU 1, between the thresholds, and none
    shifts = np.array([0.0, 0.6, 1.2, 1.8, 2.4, 6.0], np.float32)
    rois = np.zeros((1, 6, 7), np.float32)
    rois[0, :, 0] = shifts
    rois[0, :, 3:6] = [4, 2, 1.5]
    args = (rois, np.ones((1, 6), np.float32), np.ones((1, 6), np.int32),
            np.ones((1, 6), bool), gt)
    kw = dict(roi_per_image=6, fg_ratio=0.5, reg_fg_thresh=float(tc.REG_FG_THRESH),
              cls_fg_thresh=hi, cls_bg_thresh=lo, cls_bg_thresh_lo=float(tc.CLS_BG_THRESH_LO),
              hard_bg_ratio=float(tc.HARD_BG_RATIO))
    want = jax.jit(lambda *a: jax_assign_roi_targets(*a, **kw))(*(jnp.asarray(a) for a in args))
    got = assign_roi_targets(*(torch.from_numpy(a) for a in args), **kw)
    order = np.argsort(np.asarray(want.gt_iou)[0])
    w_cls, w_iou = np.asarray(want.cls_labels)[0][order], np.asarray(want.gt_iou)[0][order]
    g_order = np.argsort(got.gt_iou.numpy()[0])
    np.testing.assert_allclose(got.cls_labels.numpy()[0][g_order], w_cls, rtol=0, atol=1e-6)
    between = (w_iou > lo) & (w_iou < hi)
    assert between.any()
    assert ((w_cls[between] > 0) & (w_cls[between] < 1)).all()
    np.testing.assert_allclose(w_cls[between], (w_iou[between] - lo) / (hi - lo), rtol=1e-5)
