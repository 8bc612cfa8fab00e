"""The training slice's targets, losses, COMLoss and optimizer against the
JAX package, on the CPU.

Same numpy-seeded inputs into both (heatmap targets through the JAX
package's XLA scatter path).  Ints and masks exact; f32 values 1e-5;
the optimizer's parameters 1e-6 after each of three updates on identical
gradients.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from com_tpu.losses import centernet as jax_centernet
from com_tpu.losses import curriculum as jax_curriculum
from com_tpu.models.dense_heads import target_assign as jax_ta
from com_tpu.train import optim as jax_optim
from com_tpu.utils.config import CfgNode
from com_tpu_torch.losses import centernet, curriculum
from com_tpu_torch.models.dense_heads import target_assign
from com_tpu_torch.train import optim

torch.set_num_threads(2)
TOL = 1e-5
PC_RANGE = (-10.24, -10.24, -2.0, 10.24, 10.24, 4.0)
VSIZE = (0.32, 0.32, 6.0)
H = W = 64


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _scene(key, b=2, m=16, num_class=3):
    """gt_boxes with padded slots, a zero-size box, boxes past the range and
    overlapping centers; the COM side arrays."""
    rng = _rng("scene", key)
    gt = np.zeros((b, m, 8), np.float32)
    k = 11
    gt[:, :k, 0:2] = rng.uniform(-12.0, 12.0, (b, k, 2))
    gt[:, :k, 2] = rng.uniform(-0.5, 1.0, (b, k))
    gt[:, :k, 3:6] = rng.uniform(0.4, 9.0, (b, k, 3))
    gt[:, :k, 6] = rng.uniform(-np.pi, np.pi, (b, k))
    gt[:, :k, 7] = rng.randint(1, num_class + 1, (b, k))
    gt[:, 1, :2] = gt[:, 0, :2] + 0.05  # same cell as object 0
    gt[:, 2, 3] = 0.0                   # zero length: not a target
    return {
        "gt_boxes": gt,
        "num_points_in_gt": rng.randint(0, 30, (b, m)).astype(np.float32),
        "true_object": (rng.rand(b, m) < 0.8).astype(np.float32),
        "occupancy_ratio": rng.rand(b, m).astype(np.float32),
        "facade_type": rng.randint(0, 5, (b, m)).astype(np.float32),
    }


def _targets(key, class_ids=(1, 2, 3), vehicle_ids=(1,), min_points=0):
    s = _scene(key, num_class=len(class_ids))
    jg = jax_ta.cluster_com_groups(*(jnp.asarray(s[k]) for k in (
        "gt_boxes", "true_object", "occupancy_ratio", "facade_type")), vehicle_ids=vehicle_ids)
    tg = target_assign.cluster_com_groups(*(torch.from_numpy(s[k]) for k in (
        "gt_boxes", "true_object", "occupancy_ratio", "facade_type")), vehicle_ids=vehicle_ids)
    args = (H, W, PC_RANGE, VSIZE, 1)
    kw = dict(gaussian_overlap=0.1, min_radius=2, min_points=min_points)
    jt = jax_ta.assign_centerpoint_targets(jnp.asarray(s["gt_boxes"]),
                                           jnp.asarray(s["num_points_in_gt"]), jg, class_ids,
                                           *args, **kw)
    tt = target_assign.assign_centerpoint_targets(torch.from_numpy(s["gt_boxes"]),
                                                  torch.from_numpy(s["num_points_in_gt"]), tg,
                                                  class_ids, *args, **kw)
    return jt, tt, jg, tg


@pytest.mark.parametrize("min_points", [0, 5])
def test_targets_and_groups_match_jax(min_points):
    jt, tt, jg, tg = _targets("t", min_points=min_points)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert (tg.numpy() > 0).sum() > 5
    for name in ("inds", "mask", "center_int", "radius", "class_local", "group", "class_global"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tt.target_boxes.numpy(), np.asarray(jt.target_boxes), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(tt.heatmaps.numpy(), np.asarray(jt.heatmaps), atol=2e-6, rtol=0)
    # the positives the focal loss counts are the same cells
    np.testing.assert_array_equal(tt.heatmaps.numpy() == 1.0, np.asarray(jt.heatmaps) == 1.0)
    assert int((tt.heatmaps == 1.0).sum()) > 0


def test_single_class_groups_match_jax():
    """Single-class Vehicle: every object takes the 96-group scheme."""
    _, tt, jg, tg = _targets("v", class_ids=(1,), vehicle_ids=(1,))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tt.heatmaps.shape == (2, H, W, 1)


def _pred_hm(key, c=3):
    return _rng("hm", key).uniform(-5.0, 2.0, (2, H, W, c)).astype(np.float32)


def test_focal_and_reg_losses_match_jax():
    jt, tt, _, _ = _targets("l")
    logits = _pred_hm("l")
    jp = jax_centernet.sigmoid_clamped(jnp.asarray(logits))
    tp = centernet.sigmoid_clamped(torch.from_numpy(logits))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-7, rtol=1e-6)
    mask = _rng("mask").uniform(0.5, 1.5, (2, H, W, 3)).astype(np.float32)
    for m in (None, mask):
        want = float(jax_centernet.focal_loss_centernet(jp, jt.heatmaps,
                                                        None if m is None else jnp.asarray(m)))
        got = float(centernet.focal_loss_centernet(tp, tt.heatmaps,
                                                   None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= TOL * abs(want)
    # no positives: the loss is the negative term alone
    zero = np.zeros((2, H, W, 3), np.float32)
    np.testing.assert_allclose(
        float(centernet.focal_loss_centernet(tp, torch.from_numpy(zero))),
        float(jax_centernet.focal_loss_centernet(jp, jnp.asarray(zero))), rtol=TOL)
    boxes = _rng("boxes").randn(2, H, W, 8).astype(np.float32)
    weights = _rng("w").uniform(0.5, 1.5, (2, 16)).astype(np.float32) * np.asarray(jt.mask)
    for wmask in (jt.mask, jnp.asarray(weights)):
        want = np.asarray(jax_centernet.reg_loss_centernet(jnp.asarray(boxes), jt.inds,
                                                           jt.target_boxes, wmask))
        got = centernet.reg_loss_centernet(torch.from_numpy(boxes), tt.inds, tt.target_boxes,
                                           torch.from_numpy(np.array(wmask))).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)


def test_group_confidences_match_jax():
    jt, tt, _, _ = _targets("g")
    hm = _rng("g").rand(2, H, W, 3).astype(np.float32)
    js, jc = jax_curriculum.group_confidences(jnp.asarray(hm), jt, 3, 96)
    ts, tc = curriculum.group_confidences(torch.from_numpy(hm), tt, 3, 96)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=0)
    assert tc.sum() > 0


_CURRICULA = {
    "ucl_off": {"UCL": False, "THRESHOLD": 0.2, "ELONGATION": -10, "HEIGHT": 1, "FIX": True},
    "ucl_fix": {"UCL": True, "THRESHOLD": 0.2, "ELONGATION": -10, "HEIGHT": 1, "FIX": True},
    "ucl_ema": {"UCL": True, "THRESHOLD": 0.5, "ELONGATION": -10, "HEIGHT": 1, "ADD": 1},
    "merge": {"UCL": True, "MERGE_SCORES": True, "OFFSET": 0.5, "ELONGATION": -10,
              "HEIGHT": 1, "ALPHA": 0.01},
    "straight": {"UCL": True, "STRAIGHT": True, "K": 2.0, "THRESHOLD": 0.3, "FIX": True,
                 "RADIUS": 3},
    "tuning": {"UCL": True, "TUNING": True, "CENTER": True},
    "out_of_window": {"UCL": True, "FIX": True, "START": 5, "END": 9},
}


@pytest.mark.parametrize("initialized", [False, True])
@pytest.mark.parametrize("name", sorted(_CURRICULA))
def test_focal_loss_center_curriculum_matches_jax(name, initialized):
    cfg = _CURRICULA[name]
    jt, tt, _, _ = _targets("c")
    logits = _pred_hm("c")
    jp = jax_centernet.sigmoid_clamped(jnp.asarray(logits))
    tp = centernet.sigmoid_clamped(torch.from_numpy(logits)).requires_grad_()
    vals = (0.3, 0.25, 0.07) if initialized else (0.0, 0.0, 0.0)
    js = jax_curriculum.CurriculumState(*(jnp.float32(v) for v in vals),
                                        initialized=jnp.asarray(initialized))
    ts = curriculum.CurriculumState(*(torch.tensor(v) for v in vals),
                                    initialized=torch.tensor(initialized))
    jl, jns, jaux = jax_curriculum.focal_loss_center_curriculum(jp, jt, js, cfg, 2, 3, 96)
    tl, tns, taux = curriculum.focal_loss_center_curriculum(tp, tt, ts, cfg, 2, 3, 96)
    assert abs(float(tl.detach()) - float(jl)) <= TOL * abs(float(jl))
    for a, b in zip(tns, jns):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=TOL)
    np.testing.assert_allclose(taux.confidence_sum.numpy(), np.asarray(jaux.confidence_sum),
                               atol=TOL)
    np.testing.assert_array_equal(taux.confidence_cnt.numpy(), np.asarray(jaux.confidence_cnt))
    np.testing.assert_allclose(float(taux.avg_confidence), float(jaux.avg_confidence), rtol=TOL)
    np.testing.assert_allclose(taux.box_mask.numpy(), np.asarray(jaux.box_mask), atol=1e-6,
                               rtol=TOL)
    tl.backward()
    assert torch.isfinite(tp.grad).all()


def test_focal_loss_center_curriculum_gradient_matches_jax():
    """The COM-masked focal loss's gradient with respect to the logits."""
    import jax

    cfg = _CURRICULA["ucl_fix"]
    jt, tt, _, _ = _targets("cg")
    logits = _pred_hm("cg")
    js = jax_curriculum.CurriculumState.create()

    def f(x):
        return jax_curriculum.focal_loss_center_curriculum(
            jax_centernet.sigmoid_clamped(x), jt, js, cfg, 0, 3, 96)[0]

    want = np.asarray(jax.grad(f)(jnp.asarray(logits)))
    tx = torch.from_numpy(logits).requires_grad_()
    curriculum.focal_loss_center_curriculum(centernet.sigmoid_clamped(tx), tt,
                                            curriculum.CurriculumState.create(), cfg, 0, 3,
                                            96)[0].backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bn_wd", [True, False])
def test_adam_onecycle_matches_optax(bn_wd):
    """Three updates on identical gradients; the first has a global norm
    above GRAD_NORM_CLIP, so the clip acts."""
    rng = _rng("opt", bn_wd)
    cfg = CfgNode({"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
                   "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
                   "GRAD_NORM_CLIP": 10, "BN_WD": bn_wd})
    shapes = {"weight": (5, 4, 3, 3), "bias": (5,), "scale": (4,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * f).astype(np.float32) for k, s in shapes.items()}
             for f in (5.0, 0.3, 1e-3)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[0].values())) > 10

    tx, jlr = jax_optim.build_optimizer({k: jnp.asarray(v) for k, v in init.items()}, cfg,
                                        total_steps=7, steps_per_epoch=7)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)

    net = torch.nn.Module()
    for k, v in init.items():
        net.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt, lr_fn = optim.build_optimizer(net, cfg, total_steps=7, steps_per_epoch=7)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in net.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(lr_fn(i), float(jlr(i)), rtol=1e-6)


def test_one_cycle_schedule_matches_jax():
    jlr, jmom = jax_optim.one_cycle_schedule(0.003, 50, moms=(0.95, 0.85))
    lr, mom = optim.one_cycle_schedule(0.003, 50, moms=(0.95, 0.85))
    for s in (0, 1, 7, 19, 20, 21, 35, 49, 50, 60):
        # JAX evaluates the cosine in f32, the port in f64 on the host: near
        # the end of the anneal f32 cancellation shows at ~1e-8 of lr_max
        np.testing.assert_allclose(lr(s), float(jlr(s)), rtol=1e-6, atol=1e-6 * 0.003)
        np.testing.assert_allclose(mom(s), float(jmom(s)), rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        optim.build_optimizer(torch.nn.Linear(2, 2), CfgNode({"OPTIMIZER": name, "LR": 0.1}),
                              10, 1)
