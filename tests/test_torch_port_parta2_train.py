"""PartA2 in training, through both packages on the CPU (setup:
``tests/torch_port_parta2_setup.py``, DP_RATIO 0): ``point_part_targets``
and ``point_part_loss``; one PartA2Net train step (deterministic RoI
sampling, GT on the model's own proposals): its loss and every term
(``rpn_*``, ``point_loss_cls``, ``point_loss_part``, ``rcnn_loss_*``) to
1e-5, every gradient to the train-step tests' tolerances
(``test_torch_port_train_common``), the running statistics to theirs; the
RCNN outputs, terms and gradients, which this f32 step does not reproduce
at those tolerances in either package, to a multiple of the JAX step's own
difference with its scenes swapped where that is larger (one JAX jit of
the loss and its gradient, called twice); PartA2-free's loss composition
(the box loss, then the part loss without its class term, in the JAX
step's order) held to the JAX package's loss functions on the port's own
train forward; the port's seeded step at DP_RATIO 0.3.  And a behaviour
kept from the JAX package: ROI_AWARE_POOL.MAX_POINTS_PER_VOXEL is read by
no code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.dense_heads.point_head import point_head_box_loss as jax_point_head_box_loss
from com_tpu.models.dense_heads.point_head import point_part_loss as jax_point_part_loss
from com_tpu.models.dense_heads.point_head import point_part_targets as jax_point_part_targets
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu_torch.models.dense_heads.point_head import point_part_loss, point_part_targets
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.models.roi_heads.fc import Dropout
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, params_from_jax,
                                             state_dict_from_jax)
import test_torch_port_train_common as common
from torch_port_kitti_setup import REPO
from torch_port_parta2_setup import proposal_gt, setup, small_cfg

torch.set_num_threads(2)

TERMS = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "point_loss_cls", "point_loss_part",
         "rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"}
FORWARD_KEYS = ("point_features", "point_cls_scores_raw", "point_part_logits", "rcnn_cls",
                "rcnn_reg")
SWAP = [1, 0]  # the scenes in the other order: the same step in other f32 sums


def run_pair(seed):
    """Both packages' loss and gradients of one step (deterministic RoI
    sampling), and the JAX step once more on the batch with its scenes
    swapped."""
    cfg, jmeta, pmeta, jnet, variables, net, host = setup("parta2", seed=seed)
    host = proposal_gt(net, host, first=12)
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, _, _, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        roi_loss, roi_tb = jax_compute_roi_loss(out, cfg.MODEL)
        p_loss, p_tb = jax_point_part_loss(out)
        tb.update(roi_tb)
        tb.update(p_tb)
        fwd = {k: out[k] for k in FORWARD_KEYS + ("point_coords", "point_valid")}
        return (loss + roi_loss + p_loss,
                (mut["batch_stats"], tb, out["roi_targets"].reg_valid, fwd))

    step_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (jloss, (jbs, jtb, jfg, jfwd)), jgrads = step_fn(variables["params"],
                                                     variables["batch_stats"], host)
    (_, (_, stb, _, sfwd)), sgrads = step_fn(variables["params"], variables["batch_stats"],
                                             {k: v[SWAP] for k, v in host.items()})

    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    captured = {}
    hook = net.roi_head.register_forward_hook(lambda m, args, out: captured.update(out))
    loss, _, _, tb = step.loss_fn(state, host, 0)
    hook.remove()
    loss.backward()
    return dict(
        cfg=cfg, meta=pmeta, host=host,
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        swapped_tb={k: float(v) for k, v in stb.items()},
        jax_fg=np.asarray(jfg), jax_fwd={k: np.asarray(v) for k, v in jfwd.items()},
        swapped_fwd={k: np.asarray(sfwd[k])[SWAP] for k in FORWARD_KEYS},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        swapped_grads=params_from_jax(sgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        fwd={k: captured[k].detach().numpy() for k in FORWARD_KEYS},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k})


def step_tolerance_ratio(grads, want):
    """The worst |grads - want| over ``check_grads``' step tolerance (rtol
    1e-4, atol 1e-6 of the tensor's max |g| + 1e-5 of the net's)."""
    gmax = max(np.abs(v).max() for v in want.values())
    return max(float((np.abs(grads[k] - w) / (1e-4 * np.abs(w) + 1e-6 * np.abs(w).max()
                                               + 1e-5 * gmax)).max()) for k, w in want.items())


@pytest.fixture(scope="module")
def pair():
    return run_pair(43)


@pytest.mark.parametrize("include_cls", [True, False])
def test_point_part_loss_matches_jax(pair, include_cls):
    """On the JAX step's points and predictions, every fifth point made
    invalid: the labels (the enlarged band -1) and part targets exactly or
    to 1e-6, the focal class term and the part BCE to 1e-6."""
    r = pair
    fwd = dict(r["jax_fwd"])
    fwd["point_valid"] = fwd["point_valid"].copy()
    fwd["point_valid"][:, ::5] = False
    batch = {k: fwd[k] for k in ("point_cls_scores_raw", "point_part_logits", "point_coords",
                                 "point_valid")}
    batch["gt_boxes"] = r["host"]["gt_boxes"]
    (want, want_tb), (jlabel, jpart) = jax.jit(lambda b: (
        jax_point_part_loss(b, include_cls=include_cls),
        jax_point_part_targets(b["point_coords"], b["gt_boxes"])))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    tb_in = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got, got_tb = point_part_loss(tb_in, include_cls=include_cls)
    label, part = point_part_targets(tb_in["point_coords"], tb_in["gt_boxes"])
    np.testing.assert_array_equal(label.numpy(), np.asarray(jlabel))
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), rtol=0, atol=1e-6)
    assert (label.numpy() == 1).sum() > 10 and (label.numpy() == -1).sum() > 0
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert list(got_tb) == list(want_tb)
    for k in want_tb:
        assert float(want_tb[k]) > 0, k
        assert abs(float(got_tb[k]) - float(want_tb[k])) <= 1e-6 * float(want_tb[k]), k


def test_train_step_matches_jax(pair):
    """The train-mode forward, the loss and its terms, every gradient (the
    UNet's encoder, decoder and inverse convs, the BEV backbone, the anchor
    head, both point-head branches, the RoI head's pooled-grid convs and
    FCs) and the running statistics (the optimizer's update is the slice
tests', ``test_torch_port_train_loss.py``).

    This f32 step is not reproducible at the step tolerances in either
    package: the JAX step itself, on the same batch with its two scenes
    swapped (the same math in other f32 sums), moves the RCNN outputs by
    1e-4-5e-4 (the RoI head's
    train-mode norms over 32 rows and over the pooled grid's cells amplify
    rounding; in eval the head matches to 1e-6, ``test_torch_port_parta2.py``).
    So the forward and the terms are held
    to the larger of their tolerance (1e-4; 1e-5 of a term) and four times
    the JAX step's own difference under the swap (the swap reorders the
    batch's sums only; the port sums every reduction in its own order: the
    RCNN outputs measured 1.8-2.6 times it), the gradients to the larger
    of the step tolerance and that difference; the statistics and the
    parameters to the step tolerances."""
    r = pair
    for k in FORWARD_KEYS:
        own = np.abs(r["swapped_fwd"][k] - r["jax_fwd"][k])
        np.testing.assert_array_less(np.abs(r["fwd"][k] - r["jax_fwd"][k]),
                                     np.maximum(1e-4 + 1e-4 * np.abs(r["jax_fwd"][k]),
                                                4 * own.max()) + 1e-12, err_msg=k)
    assert set(r["tb"]) == set(r["jax_tb"]) == TERMS
    assert r["jax_fg"].sum() > 0 and r["tb"]["rcnn_loss_reg"] > 0
    for k, v in r["jax_tb"].items():
        own = abs(r["swapped_tb"][k] - v)
        assert abs(r["tb"][k] - v) <= max(1e-5 * max(abs(v), 1e-6), 4 * own), k
    own = abs(sum(r["swapped_tb"].values()) - r["jax_loss"])
    assert abs(r["loss"] - r["jax_loss"]) <= max(1e-5 * abs(r["jax_loss"]), 4 * own)
    for prefix in ("backbone_3d.conv_input.", "backbone_3d.conv4.0.", "backbone_3d.conv_out.",
                   "backbone_3d.inv_conv4.", "backbone_3d.conv_up_t1.", "backbone_3d.conv5.",
                   "backbone_2d.", "dense_head.", "point_head.part_reg_layers.",
                   "roi_head.conv_part.", "roi_head.conv_rpn.", "roi_head.shared_fc_layer."):
        assert any(k.startswith(prefix) and np.abs(g).max() > 0
                   for k, g in r["grads"].items()), prefix
    assert set(r["grads"]) == set(r["jax_grads"])
    own = step_tolerance_ratio(r["swapped_grads"], r["jax_grads"])
    assert step_tolerance_ratio(r["grads"], r["jax_grads"]) <= max(1.0, own), own
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)


def test_parta2_free_loss_composition_matches_jax():
    """PartA2-free's step (no dense head): the RoI losses, then the box
    head's loss (which trains the shared class logits), then the part loss
    without a class term, the JAX step's "not elif" order; each term and
    the total held to the JAX package's loss functions over the port's own
    train-mode forward to 1e-5, the terms in the JAX step's order."""
    cfg, _, pmeta, _, _, net, host = setup("free")
    names = list(cfg.CLASS_NAMES)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    captured = {}
    hook = net.roi_head.register_forward_hook(lambda m, args, out: captured.update(out))
    loss, _, _, tb = step.loss_fn(state, host, 0)
    hook.remove()
    keys = ("point_cls_preds", "point_box_preds_raw", "point_cls_scores_raw",
            "point_part_logits", "point_coords", "point_valid", "gt_boxes", "rcnn_cls",
            "rcnn_reg")
    out = {k: jnp.asarray(captured[k].detach().numpy()) for k in keys}
    out["roi_targets"] = jax.tree_util.tree_map(lambda x: jnp.asarray(x.detach().numpy()),
                                                captured["roi_targets"])

    def jax_terms(o):
        tb_ = {}
        total, roi_tb = jax_compute_roi_loss(o, cfg.MODEL)
        tb_.update(roi_tb)
        box, box_tb = jax_point_head_box_loss(o, cfg.MODEL.POINT_HEAD)
        tb_.update(box_tb)
        part, part_tb = jax_point_part_loss(o, include_cls="point_box_preds_raw" not in o)
        tb_.update(part_tb)
        return jnp.zeros(()) + total + box + part, tb_

    want, want_tb = jax.jit(jax_terms)(out)  # a jitted dict comes back in key order
    assert list(tb) == ["rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner", "point_loss_cls",
                        "point_loss_box", "point_loss_part"]
    assert set(tb) == set(want_tb)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    for k, v in want_tb.items():
        assert abs(float(tb[k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-6), k
    assert float(tb["point_loss_part"]) > 0 and float(tb["point_loss_box"]) > 0
    loss.backward()
    assert net.point_head.part_reg_layers[0].weight.grad.abs().max() > 0


def test_train_step_at_dp_ratio_03_is_a_function_of_its_seed(pair):
    """The whole step at the YAML's DP_RATIO 0.3 (a dropout after the first
    FC of each branch) on seeded weights, twice from the same start:
    bitwise the same metrics, every term finite."""
    cfg = small_cfg("parta2", dp_ratio=0.3)
    names = list(cfg.CLASS_NAMES)
    runs = []
    for _ in range(2):
        net = build_network(cfg.MODEL, pair["meta"], device="cpu", seed=3)
        assert any(isinstance(m, Dropout) for m in net.roi_head.cls_layers)
        with torch.no_grad():
            net.dense_head.conv_cls.bias.add_(4.0)
            net.dense_head.conv_box.weight.mul_(0.02)
        opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
        state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                                  device="cpu", **curriculum_kwargs(cfg.MODEL, names))
        step = make_train_step(net, cfg.MODEL, names, pair["meta"], opt, None, device="cpu",
                               seed=5)
        _, metrics = step(state, pair["host"], 0)
        runs.append({k: float(v.sum()) for k, v in metrics.items()})
    assert runs[0] == runs[1]
    assert TERMS <= set(runs[0]) and all(np.isfinite(v) for v in runs[0].values())


def test_max_points_per_voxel_is_read_by_no_code(pair):
    """Kept from com_tpu: ROI_AWARE_POOL.MAX_POINTS_PER_VOXEL (pcdet's cap of
    the points a pooled cell keeps) is read by no code of either package:
    no module that reads ROI_AWARE_POOL names it, only MAX_POINTS_PER_ROI
    caps a RoI's members, and the port's head gives the same outputs with
    the cap at 1 as at the YAML's 128."""
    for pkg in ("com_tpu", "com_tpu_torch"):
        readers = [p for p in (REPO / pkg).rglob("*.py") if "ROI_AWARE_POOL" in p.read_text()]
        assert readers and any("MAX_POINTS_PER_ROI" in p.read_text() for p in readers), pkg
        for path in readers:
            assert "MAX_POINTS_PER_VOXEL" not in path.read_text(), path
    cfg = small_cfg("parta2")
    pool = cfg.MODEL.ROI_HEAD.ROI_AWARE_POOL
    assert pool.MAX_POINTS_PER_VOXEL == 128
    batch = {k: torch.from_numpy(np.array(v)) for k, v in pair["jax_fwd"].items()
             if k in ("point_coords", "point_features", "point_valid")}
    batch["rois"] = torch.from_numpy(pair["host"]["gt_boxes"][..., :7].copy())
    scores = torch.sigmoid(torch.from_numpy(np.array(pair["jax_fwd"]["point_cls_scores_raw"])))
    batch.update(point_cls_scores=scores, point_part_offset=torch.sigmoid(
        torch.from_numpy(np.array(pair["jax_fwd"]["point_part_logits"]))))
    outs = []
    for cap in (128, 1):
        pool.MAX_POINTS_PER_VOXEL = cap
        head = build_network(cfg.MODEL, pair["meta"], device="cpu", seed=3).roi_head
        with torch.no_grad():
            outs.append(head(dict(batch))["rcnn_reg"])
    assert torch.equal(outs[0], outs[1])
