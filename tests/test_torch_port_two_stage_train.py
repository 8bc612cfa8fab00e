"""One Voxel-RCNN and one SECOND-IoU train step through both packages on
the CPU (setup and narrowing: ``tests/torch_port_two_stage_setup.py``,
DP_RATIO 0): the loss and every term (``rpn_*``, ``rcnn_loss_cls``,
``rcnn_loss_reg``, ``rcnn_loss_corner``, ``rcnn_loss_iou``) to 1e-5, every
gradient and the batch statistics to the train-step tests' tolerances
(``test_torch_port_train_common``), with the RoI sampling random and fed
the uniforms the JAX step draws from its ``roi_sampling`` key; then the
port's whole ``train_step`` with its own seeded generators (dropout on):
finite, foreground RoIs, a pure function of the seed.  One JAX jit of the
loss and its gradient a detector.
"""
import jax
import numpy as np
import pytest
import torch
from flax import linen as nn

from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.roi_heads.second_head import second_iou_loss as jax_second_iou_loss
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.models.roi_heads.fc import Dropout
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import (conf_shape_for, curriculum_kwargs, make_train_step,
                                      step_generators)
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, params_from_jax,
                                             state_dict_from_jax)
import test_torch_port_train_common as common
from torch_port_two_stage_setup import setup, small_cfg

torch.set_num_threads(2)


class _DrawsRoISampling(nn.Module):
    """A top-level module that draws its "roi_sampling" key as the JAX
    detector's ``_stage2_rois`` does (``self.make_rng`` at the top scope,
    first call): the same key, so the same uniforms."""

    @nn.compact
    def __call__(self):
        return self.make_rng("roi_sampling")


def jax_roi_uniforms(key, b, p):
    derived = _DrawsRoISampling().apply({}, rngs={"roi_sampling": key})
    return np.stack([np.asarray(jax.random.uniform(k, (p,)))
                     for k in jax.random.split(derived, b)])


def run_pair(which, seed):
    cfg, jmeta, pmeta, jnet, variables, net, host = setup(which, seed)
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)
    key = jax.random.PRNGKey(seed)
    roi_cfg = cfg.MODEL.ROI_HEAD

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"], rngs={"roi_sampling": key})
        loss, _, _, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        if "rcnn_cls" in out:
            roi_loss, roi_tb = jax_compute_roi_loss(out, cfg.MODEL)
            tb.update(roi_tb)
        else:
            roi_loss = tb["rcnn_loss_iou"] = jax_second_iou_loss(out, roi_cfg.LOSS_CONFIG)
        t = out["roi_targets"]
        return loss + roi_loss, (mut["batch_stats"], tb, t.reg_valid, t.rois)

    (jloss, (jbs, jtb, jfg, jrois)), jgrads = common.jax_value_and_grad(loss_fn, variables, host)
    p = int(roi_cfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    u = torch.from_numpy(jax_roi_uniforms(key, 2, p))

    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    loss, _, _, tb = step.loss_fn(state, host, 0, rngs={"roi_sampling": u})
    loss.backward()
    return dict(
        cfg=cfg, pmeta=pmeta, host=host,
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_fg=np.asarray(jfg), jax_rois=np.asarray(jrois),
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k})


@pytest.fixture(scope="module")
def voxel_rcnn_pair():
    return run_pair("voxel_rcnn", seed=31)


def test_voxel_rcnn_step_terms_match_jax(voxel_rcnn_pair):
    r = voxel_rcnn_pair
    assert set(r["tb"]) == set(r["jax_tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
        "rcnn_loss_corner"}
    assert r["jax_fg"].sum() > 0  # the reg and corner losses see foreground RoIs
    common.check_loss_and_tb(dict(r, metrics={"loss": r["loss"]}))


def test_voxel_rcnn_step_gradients_and_stats_match_jax(voxel_rcnn_pair):
    r = voxel_rcnn_pair
    assert any(k.startswith("roi_head.roi_grid_pool_layers.") for k in r["grads"])
    common.check_grads(r)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)


def test_voxel_rcnn_train_step_is_a_function_of_its_seed(voxel_rcnn_pair):
    """The whole step (seeded RoI sampling, dropout 0.3) on seeded weights
    (the class bias raised, the box kernel shrunk), twice from the same
    start: bitwise the same metrics; finite; foreground RoIs drawn."""
    r = voxel_rcnn_pair
    cfg = small_cfg("voxel_rcnn", dp_ratio=0.3)
    names = list(cfg.CLASS_NAMES)
    runs = []
    for _ in range(2):
        net = build_network(cfg.MODEL, r["pmeta"], device="cpu", seed=3)
        assert any(isinstance(m, Dropout) for m in net.roi_head.shared_fc_layer)
        with torch.no_grad():
            net.dense_head.conv_cls.bias.add_(4.0)
            net.dense_head.conv_box.weight.mul_(0.02)
        opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
        state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                                  device="cpu", **curriculum_kwargs(cfg.MODEL, names))
        step = make_train_step(net, cfg.MODEL, names, r["pmeta"], opt, None, device="cpu",
                               seed=5)
        _, metrics = step(state, r["host"], 0)
        runs.append({k: float(v.sum()) for k, v in metrics.items()})
    assert runs[0] == runs[1]
    assert all(np.isfinite(v) for v in runs[0].values())
    for k in ("rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"):
        assert runs[0][k] > 0, k
    g = step_generators(5, 0, "cpu")
    assert set(g) == {"roi_sampling", "dropout"}
    assert torch.equal(torch.rand(4, generator=g["roi_sampling"]),
                       torch.rand(4, generator=step_generators(5, 0, "cpu")["roi_sampling"]))
    assert not torch.equal(torch.rand(4, generator=step_generators(5, 1, "cpu")["roi_sampling"]),
                           torch.rand(4, generator=step_generators(5, 0, "cpu")["roi_sampling"]))


@pytest.fixture(scope="module")
def second_iou_pair():
    return run_pair("second_iou", seed=32)


def test_second_iou_step_matches_jax(second_iou_pair):
    """SECOND-IoU: the loss and its terms (``rcnn_loss_iou`` BCE on the
    soft IoU labels), every gradient, the batch statistics."""
    r = second_iou_pair
    assert set(r["tb"]) == set(r["jax_tb"]) == {
        "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_iou"}
    assert r["jax_fg"].sum() > 0 and r["tb"]["rcnn_loss_iou"] > 0
    common.check_loss_and_tb(dict(r, metrics={"loss": r["loss"]}))
    assert any(k.startswith("roi_head.iou_layers.") for k in r["grads"])
    common.check_grads(r)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
