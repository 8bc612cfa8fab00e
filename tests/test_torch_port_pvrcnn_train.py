"""PV-RCNN and PV-RCNN++ in training, through both packages on the CPU
(setup: ``tests/torch_port_pvrcnn_setup.py``, DP_RATIO 0): a train-mode
forward (the keypoints, their features under the masked norms' batch
statistics, the point head's logits, the RoI head's outputs on the
sampled RoIs) and ``point_head_loss``; one train step each, the loss and
every term (``rpn_*``, ``rcnn_loss_cls``, ``rcnn_loss_reg``,
``point_loss_cls``) to 1e-5, every gradient and the running statistics
to the train-step tests' tolerances (``test_torch_port_train_common``),
the parameters after the optax update, with the RoI sampling fed the
uniforms the JAX step draws.  One JAX jit of the loss and its gradient a
detector.
"""
import jax
import numpy as np
import pytest
import torch

from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.dense_heads.point_head import point_head_loss as jax_point_head_loss
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu.utils.config import CfgNode as JaxCfgNode
from com_tpu_torch.models.dense_heads.point_head import point_head_loss
from com_tpu_torch.ops.boxes import points_in_rbbox
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, params_from_jax,
                                             state_dict_from_jax)
import test_torch_port_train_common as common
from test_torch_port_two_stage_train import jax_roi_uniforms
from torch_port_pvrcnn_setup import setup

torch.set_num_threads(2)

TERMS = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
         "point_loss_cls"}
FORWARD_KEYS = ("point_coords", "point_valid", "point_features", "point_cls_scores_raw",
                "rcnn_cls", "rcnn_reg")


def run_pair(which, seed):
    cfg, jmeta, pmeta, jnet, variables, net, host = setup(which, seed)
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)
    key = jax.random.PRNGKey(seed)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"], rngs={"roi_sampling": key})
        loss, _, _, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        roi_loss, roi_tb = jax_compute_roi_loss(out, cfg.MODEL)
        p_loss = jax_point_head_loss(out)
        tb.update(roi_tb, point_loss_cls=p_loss)
        fwd = {k: out[k] for k in FORWARD_KEYS}
        return loss + roi_loss + p_loss, (mut["batch_stats"], tb, out["roi_targets"].reg_valid,
                                          fwd)

    (jloss, (jbs, jtb, jfg, jfwd)), jgrads = common.jax_value_and_grad(loss_fn, variables, host)
    nms = cfg.MODEL.ROI_HEAD.NMS_CONFIG
    p = int(nms.TRAIN.NMS_POST_MAXSIZE) if "TRAIN" in nms else int(nms.TRAIN_PRE)
    u = torch.from_numpy(jax_roi_uniforms(key, 2, p))
    jtx, _ = jax_build_optimizer(variables["params"], JaxCfgNode(dict(cfg.OPTIMIZATION)),
                                 100, 10)
    updates, _ = jtx.update(jgrads, jtx.init(variables["params"]), variables["params"])
    jparams = jax.tree_util.tree_map(lambda a, b: np.asarray(a + b), variables["params"], updates)

    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    captured = {}
    hook = net.roi_head.register_forward_hook(lambda m, args, out: captured.update(out))
    loss, _, _, tb = step.loss_fn(state, host, 0, rngs={"roi_sampling": u})
    hook.remove()
    loss.backward()
    opt.step()
    return dict(
        cfg=cfg, host=host, jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_fg=np.asarray(jfg), jax_fwd={k: np.asarray(v) for k, v in jfwd.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        jax_params=params_from_jax(jparams, cfg.MODEL, names),
        fwd={k: captured[k].detach().numpy() for k in FORWARD_KEYS},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        params={k: q.detach().numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k})


@pytest.fixture(scope="module")
def pvrcnn_pair():
    return run_pair("pvrcnn", seed=51)


@pytest.fixture(scope="module")
def pvrcnn_plusplus_pair():
    return run_pair("pvrcnn_plusplus", seed=52)


@pytest.mark.parametrize("which", ["pvrcnn", "pvrcnn_plusplus"])
def test_train_mode_forward_matches_jax(which, request):
    """The keypoints exactly, their features (batch statistics over the
    real neighbours and the valid keypoints), the point logits and the RoI
    head's outputs on the sampled RoIs to 1e-4."""
    r = request.getfixturevalue(f"{which}_pair")
    for k in FORWARD_KEYS:
        if k in ("point_coords", "point_valid"):
            np.testing.assert_array_equal(r["fwd"][k], r["jax_fwd"][k], err_msg=k)
        else:
            np.testing.assert_allclose(r["fwd"][k], r["jax_fwd"][k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_point_head_loss_matches_jax(pvrcnn_pair):
    """``point_head_loss`` on the JAX step's keypoints and logits, GT in the
    enlarged boxes, some keypoints invalid: to 1e-6; and a foreground to
    learn from."""
    import jax.numpy as jnp

    r = pvrcnn_pair
    fwd = r["jax_fwd"]
    valid = fwd["point_valid"].copy()
    valid[:, ::7] = False
    batch = {"point_cls_scores_raw": fwd["point_cls_scores_raw"],
             "point_coords": fwd["point_coords"], "point_valid": valid,
             "gt_boxes": r["host"]["gt_boxes"]}
    want = float(jax_point_head_loss({k: jnp.asarray(v) for k, v in batch.items()}))
    got = float(point_head_loss({k: torch.from_numpy(np.array(v)) for k, v in batch.items()}))
    assert abs(got - want) <= 1e-6 * abs(want) and want > 0
    gt = torch.from_numpy(np.array(r["host"]["gt_boxes"]))
    inside = points_in_rbbox(torch.from_numpy(np.array(fwd["point_coords"])), gt[..., :7])
    assert int((inside & (gt[..., 7] > 0)[:, None, :]).any(-1).sum()) > 0


@pytest.mark.parametrize("which", ["pvrcnn", "pvrcnn_plusplus"])
def test_train_step_matches_jax(which, request):
    """The loss and its terms, every gradient (the PFE's blocks, the point
    head, the RoI head included), the running statistics, and the
    parameters after Adam."""
    r = request.getfixturevalue(f"{which}_pair")
    assert set(r["tb"]) == set(r["jax_tb"]) == TERMS
    assert r["jax_fg"].sum() > 0 and r["tb"]["rcnn_loss_reg"] > 0
    common.check_loss_and_tb(dict(r, metrics={"loss": r["loss"]}))
    for prefix in ("pfe.SA_rawpoints.", "pfe.SA_layers.1.", "pfe.vsa_point_feature_fusion.",
                   "point_head.cls_layers.", "roi_head."):
        assert any(k.startswith(prefix) for k in r["grads"]), prefix
    common.check_grads(r)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    common.check_params_after_step(r)
