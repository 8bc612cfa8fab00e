"""One anchor-head train step through both packages, and the anchor
curriculum state through checkpoints and the JAX bridge, on the CPU.

KITTI PointPillars at a 64x64 grid, batch 2, 16 object slots of which 6 a
scene are real, f32 on both sides, with and without a ``LOSS_CURRICULUM``
(as ``tests/test_anchor_path.py`` sets it: no shipped YAML turns the anchor
curriculum on).  The JAX side runs ``jax.value_and_grad`` of its
``compute_anchor_loss``; the port ``train_step.loss_fn`` + backward, then a
whole ``train_step`` from the same start.  Loss and gradients are held to
the tolerance of ``test_torch_port_train_step.py``; batch statistics, the
new ``AnchorCurriculumState`` and the (3, 96) accumulators to 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.losses.anchor_losses import AnchorCurriculumState as JaxAnchorState
from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.state import TrainState as JaxTrainState
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu_torch.losses.anchor_losses import AnchorCurriculumState
from com_tpu_torch.losses.curriculum import CurriculumState
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, load_jax_variables,
                                             params_from_jax, state_dict_from_jax,
                                             train_state_from_jax)
from test_torch_port_anchor import (GRID, LOSS_CURRICULUM, PC_RANGE, VSIZE, jax_variables,
                                    scene_batch, small_kitti_cfg)
from test_torch_port_train_common import check_grads

torch.set_num_threads(2)

TOTAL_STEPS = 100
START_MEANS, START_STDS, START_INIT = [0.3, 0.25, 0.2], [0.05, 0.1, 0.02], [True, False, True]


def train_batch(rng, b=2, n=8192, m=16, real=6):
    """``scene_batch`` with KITTI-sized objects of the three classes and the
    COM side arrays."""
    batch = scene_batch(rng, b, n)
    gt = np.zeros((b, m, 8), np.float32)
    sizes = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)
    for i in range(b):
        cls = np.array([1, 2, 3] * (real // 3))
        gt[i, :real, 0] = rng.uniform(1.0, 9.2, real)
        gt[i, :real, 1] = rng.uniform(-4.0, 4.0, real)
        gt[i, :real, 2] = rng.uniform(-1.6, -0.6, real)
        gt[i, :real, 3:6] = sizes[cls - 1] * rng.uniform(0.9, 1.1, (real, 3))
        gt[i, :real, 6] = rng.uniform(-np.pi, np.pi, real)
        gt[i, :real, 7] = cls
    real_mask = gt[..., 7] > 0
    batch.update(gt_boxes=gt, num_points_in_gt=real_mask.astype(np.float32) * 10,
                 true_object=real_mask.astype(np.float32),
                 occupancy_ratio=rng.rand(b, m).astype(np.float32),
                 facade_type=rng.randint(0, 4, (b, m)).astype(np.float32))
    return batch


def anchor_cfg(curriculum: bool):
    cfg = small_kitti_cfg()
    if curriculum:
        cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM = dict(LOSS_CURRICULUM)
    return cfg


def run_slice(curriculum: bool, epoch: int = 0):
    """Both packages' anchor step from the same start; a dict of results."""
    cfg = anchor_cfg(curriculum)
    names = list(cfg.CLASS_NAMES)
    meta = JaxMeta(names, PC_RANGE, VSIZE, GRID, 4)
    host = train_batch(np.random.RandomState(8))
    jnet, variables = jax_variables(cfg, meta, host, seed=9)
    if curriculum:
        jcur = (JaxAnchorState(jnp.asarray(START_MEANS, jnp.float32),
                               jnp.asarray(START_STDS, jnp.float32), jnp.asarray(START_INIT)),)
    else:
        jcur = (JaxCurriculumState.create(),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, new_cur, aux, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, meta, jcur, epoch)
        return loss, (mut["batch_stats"], new_cur, aux, tb)

    (jloss, (jbs, jnew, jaux, jtb)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"],
                                                   variables["batch_stats"], host)

    pmeta = DatasetMeta(names, PC_RANGE, VSIZE, GRID, 4)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    start = copy.deepcopy(net.state_dict())
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    loss, new_cur, aux, tb = step.loss_fn(state, host, epoch)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k}
    net.load_state_dict(start)
    net.zero_grad(set_to_none=True)
    state, metrics = step(state, host, epoch)
    return dict(
        cfg=cfg, names=names, variables=variables, jnet=jnet, host=host, curriculum=curriculum,
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        jax_cur=jnew[0], jax_conf=(np.asarray(jaux[0].confidence_sum),
                                   np.asarray(jaux[0].confidence_cnt)),
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads=grads, stats=stats, cur=new_cur[0], metrics=metrics, state=state,
        conf=(state.conf_sum.numpy().copy(), state.conf_cnt.numpy().copy()))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "curriculum"])
def anchor_slice(request):
    return run_slice(request.param)


def test_anchor_loss_and_tb_match_jax(anchor_slice):
    r = anchor_slice
    assert set(r["tb"]) == set(r["jax_tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir"}
    assert abs(r["loss"] - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])
    for k, v in r["jax_tb"].items():
        assert abs(r["tb"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k
    assert abs(float(r["metrics"]["loss"]) - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])


def test_anchor_gradients_match_jax(anchor_slice):
    check_grads(anchor_slice)


def test_anchor_statistics_and_curriculum_match_jax(anchor_slice):
    """Batch statistics; the curriculum state (the anchor EMA moved from its
    start, or the center kind passed through); the (3, 96) accumulators."""
    r = anchor_slice
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    cur, jcur = r["cur"], r["jax_cur"]
    assert type(cur).__name__ == type(jcur).__name__
    for f in cur._fields:
        np.testing.assert_allclose(getattr(cur, f).numpy(), np.asarray(getattr(jcur, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    js, jc = r["jax_conf"]
    np.testing.assert_array_equal(r["conf"][1], jc)
    np.testing.assert_allclose(r["conf"][0], js, rtol=1e-5, atol=1e-5)
    if r["curriculum"]:
        assert jc.sum() > 0 and bool(cur.initialized.all())
        assert not np.allclose(cur.means.numpy(), START_MEANS)
    else:  # no curriculum, no COM groups: the accumulators stay zero
        assert jc.sum() == 0 and isinstance(cur, CurriculumState)


def test_anchor_checkpoint_roundtrip(anchor_slice, tmp_path):
    """The state after the step, curriculum of either kind, through a file
    that ``weights_only=True`` reads, into a fresh state bitwise; a
    checkpoint of the other kind does not load."""
    r = anchor_slice
    state = r["state"]
    path = save_checkpoint(state, tmp_path, epoch=1, it=1)
    cfg, names = r["cfg"], r["names"]
    net = build_network(cfg.MODEL, DatasetMeta(names, PC_RANGE, VSIZE, GRID, 4), device="cpu",
                        seed=3)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    kw = curriculum_kwargs(cfg.MODEL, names)
    fresh = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **kw)
    payload = load_checkpoint(path, fresh)
    assert payload["curriculum"][0]["kind"] == type(state.curriculum[0]).__name__
    assert type(fresh.curriculum[0]) is type(state.curriculum[0])
    for a, b in zip(fresh.curriculum[0], state.curriculum[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k, v in state.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[k], v), k
    assert torch.equal(fresh.conf_sum, state.conf_sum) and fresh.step == state.step == 1
    other = dict(kw, anchor_num_class=None if kw["anchor_num_class"] else 3)
    wrong = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **other)
    with pytest.raises(ValueError, match="checkpoint holds a"):
        load_checkpoint(path, wrong)


def test_train_state_from_jax_carries_an_anchor_state():
    """A ``com_tpu`` anchor TrainState (curriculum of the anchor kind, moved
    from zero) into the port: weights and the curriculum as they are."""
    cfg = anchor_cfg(True)
    names = list(cfg.CLASS_NAMES)
    meta = JaxMeta(names, PC_RANGE, VSIZE, GRID, 4)
    host = scene_batch(np.random.RandomState(1), n=512)
    _, variables = jax_variables(cfg, meta, host, seed=4)
    tx, _ = jax_build_optimizer(variables["params"], cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    js = JaxTrainState.create(variables, tx, num_head_groups=1, anchor_num_class=3,
                              conf_shape=(3, 96))
    jcur = JaxAnchorState(jnp.asarray(START_MEANS, jnp.float32),
                          jnp.asarray(START_STDS, jnp.float32), jnp.asarray(START_INIT))
    js = js.replace(curriculum=(jcur,))
    net = build_network(cfg.MODEL, DatasetMeta(names, PC_RANGE, VSIZE, GRID, 4), device="cpu")
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    state = TrainState.create(net, opt, conf_shape=(3, 96), device="cpu",
                              **curriculum_kwargs(cfg.MODEL, names))
    train_state_from_jax({"state": js}, state, cfg.MODEL, names)
    (cur,) = state.curriculum
    assert isinstance(cur, AnchorCurriculumState)
    np.testing.assert_array_equal(cur.means.numpy(), np.float32(START_MEANS))
    np.testing.assert_array_equal(cur.stds.numpy(), np.float32(START_STDS))
    np.testing.assert_array_equal(cur.initialized.numpy(), START_INIT)
    w = variables["params"]["AnchorHeadSingle_0"]["conv_cls"]["kernel"]
    np.testing.assert_array_equal(net.dense_head.conv_cls.weight.detach().numpy(),
                                  np.asarray(w).transpose(3, 2, 0, 1))
