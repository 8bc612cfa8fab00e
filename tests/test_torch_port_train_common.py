"""One training step of the flagship config through both packages, for the
``tests/test_torch_port_train_{step,ucl}.py`` slice tests (this module holds
their shared setup and checks, and no tests of its own).

The flagship CenterPoint-Pillar config at a 64x64 grid, batch 2, ~4k
presorted points a scene and 16 object slots (``__graft_entry__._build``),
f32 on both sides (MIXED_PRECISION off).  The JAX variables are perturbed
from a seed (batch statistics included) and the curriculum EMA starts away
from zero; the weight bridge carries both into the port.  The JAX side runs
``jax.value_and_grad`` of its CenterPoint loss (jitted once) and its optax
chain; the port runs ``train_step.loss_fn`` + backward, then a whole
``train_step`` from the same start.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.step import compute_centerpoint_loss as jax_compute_loss
from com_tpu.train.step import conf_shape_for
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import make_train_step
from com_tpu_torch.utils.config import cfg_from_yaml_file
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, load_jax_variables,
                                             params_from_jax, state_dict_from_jax)

GRID = (64, 64, 1)
TOTAL_STEPS = 100
FLAGSHIP = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"


def tiny_cfg():
    """The flagship config (port's loader) with a narrow one-block backbone,
    16 object slots and f32, for loop and rule tests at a 32x32 grid."""
    cfg = cfg_from_yaml_file(FLAGSHIP)
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.VFE.NUM_FILTERS = [16, 16]
    m.BACKBONE_2D.update(LAYER_NUMS=[1], LAYER_STRIDES=[1], NUM_FILTERS=[16],
                         UPSAMPLE_STRIDES=[1], NUM_UPSAMPLE_FILTERS=[16])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 16
    return cfg


def tiny_batch(rng, b=2, n=1024, m=16):
    """A scene batch for ``tiny_cfg`` (range +-5.12 m): points, 6 boxes a
    scene in 16 slots, the COM side arrays."""
    pts = np.concatenate([rng.uniform(-5, 5, (b, n, 2)), rng.uniform(-1.5, 3.5, (b, n, 1)),
                          rng.rand(b, n, 2)], -1).astype(np.float32)
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-4, 4, (b, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 3.0, (b, 6, 3))
    gt[:, :6, 6] = rng.uniform(-np.pi, np.pi, (b, 6))
    gt[:, :6, 7] = rng.randint(1, 4, (b, 6))
    return {"points": pts, "points_mask": np.ones((b, n), bool), "gt_boxes": gt,
            "num_points_in_gt": (gt[..., 7] > 0).astype(np.float32) * 10,
            "true_object": (gt[..., 7] > 0).astype(np.float32),
            "occupancy_ratio": rng.rand(b, m).astype(np.float32),
            "facade_type": rng.randint(0, 4, (b, m)).astype(np.float32)}


def perturb(variables, seed):
    """Seeded perturbation of every leaf: kernels and biases get noise, BN
    scale/bias/mean shift, BN variances scale in [0.5, 1.5].  The norms'
    biases also move up by 3 (about 3 standard deviations of their
    normalised input), so that almost no ReLU input sits near 0.  A
    gradient is chaotic where one does: a rounding-sized change of the
    weights flips a ReLU and moves the weight gradients upstream of it far
    past 1e-4 of their size, on either package alone, so no comparison
    between two implementations at 1e-4 could survive it."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "var":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1] == "scale":
            return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        scale = 0.1 if path[-1] in ("bias", "mean") else 0.05 * (np.abs(a).mean() + 1e-3)
        shift = 3.0 if path[0] == "params" and path[-1] == "bias" and "Norm" in path[-2] else 0.0
        return a + shift + scale * rng.randn(*a.shape).astype(np.float32)

    return {coll: walk(tree, (coll,)) for coll, tree in variables.items()
            if coll in ("params", "batch_stats")}


def run_slice(ucl: bool, epoch: int = 0):
    """Both packages' step from the same start; returns a dict of results."""
    cfg, meta, _, batch = graft._build(batch_size=2, num_points=4096, grid=GRID,
                                       num_max_objs=16)
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = ucl
    host = {k: np.array(v) for k, v in batch.items()}
    return run_step_pair(cfg, meta, host, ("points", "points_mask"), epoch)


def run_step_pair(cfg, meta, host, input_keys, epoch=0, seed=2):
    """The JAX loss, gradients and optax update against the port's
    ``loss_fn`` + backward and a whole ``train_step``, from the same
    perturbed start (``perturb(seed)``, the curriculum EMA away from zero);
    ``input_keys`` are the model's inputs in ``host`` (for the JAX init)."""
    names = list(cfg.CLASS_NAMES)
    jnet = jax_build_network(cfg.MODEL, meta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in input_keys}, train=False)
    variables = perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=seed)
    cur = (JaxCurriculumState(avg_confidence=jnp.float32(0.12), mean=jnp.float32(0.2),
                              std=jnp.float32(0.05), initialized=jnp.asarray(True)),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, new_cur, aux, tb = jax_compute_loss(out, cfg.MODEL, names, meta, cur, epoch,
                                                  GRID[:2])
        return loss, (mut["batch_stats"], new_cur, aux, tb)

    (jloss, (jbs, jcur, jaux, jtb)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"],
                                                   variables["batch_stats"], host)
    tx, _ = jax_build_optimizer(variables["params"], cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
    jparams = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), variables["params"], updates)

    pmeta = DatasetMeta(meta.class_names, meta.point_cloud_range, meta.voxel_size,
                        meta.grid_size, meta.num_point_features)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    start = copy.deepcopy(net.state_dict())
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device="cpu")
    state.curriculum = curriculum_state_from_jax(cur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, GRID[:2], device="cpu")

    loss, new_cur, aux, tb = step.loss_fn(state, host, epoch)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k}
    net.load_state_dict(start)
    net.zero_grad(set_to_none=True)
    state, metrics = step(state, host, epoch)

    return dict(
        cfg=cfg, names=names, variables=variables, tx=tx, jgrads=jgrads,
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        jax_cur=jcur[0], jax_conf=(np.asarray(sum(a.confidence_sum for a in jaux)),
                                   np.asarray(sum(a.confidence_cnt for a in jaux))),
        jax_params=params_from_jax(jparams, cfg.MODEL, names),
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()}, grads=grads,
        stats=stats, cur=new_cur[0], metrics=metrics, state=state,
        params={k: p.detach().numpy().copy() for k, p in net.named_parameters()},
        conf=(state.conf_sum.numpy(), state.conf_cnt.numpy()),
    )


def check_loss_and_tb(r):
    assert abs(r["loss"] - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])
    assert set(r["tb"]) == set(r["jax_tb"])
    for k, v in r["jax_tb"].items():
        assert abs(r["tb"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k
    assert abs(float(r["metrics"]["loss"]) - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])


def check_grads(r):
    """rtol 1e-4 with atol 1e-6 of the tensor's max |g|, plus 1e-5 of the
    net's max |g|: some gradients are 0 in exact arithmetic (a conv bias
    before a training-mode norm; a norm bias whose constant shift the next
    norm removes), and what both sides read there is rounding noise of the
    whole net's gradient."""
    g, jg = r["grads"], r["jax_grads"]
    assert set(g) == set(jg)
    gmax = max(np.abs(v).max() for v in jg.values())
    for k, want in jg.items():
        np.testing.assert_allclose(g[k], want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max() + 1e-5 * gmax, err_msg=k)


def check_state(r):
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    for name in ("avg_confidence", "mean", "std", "initialized"):
        np.testing.assert_allclose(getattr(r["cur"], name).numpy(),
                                   np.asarray(getattr(r["jax_cur"], name)), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    js, jc = r["jax_conf"]
    assert jc.sum() > 0
    np.testing.assert_array_equal(r["conf"][1], jc)
    np.testing.assert_allclose(r["conf"][0], js, rtol=1e-5, atol=1e-5)


def check_params_after_step(r):
    """Adam turns a gradient into ~±lr whatever its size, so parameters are
    compared where |g| is not tiny, against its tensor and against the net
    (the rounding-noise gradients of ``check_grads`` are left out): there
    both sides move the same way."""
    gmax = max(np.abs(v).max() for v in r["jax_grads"].values())
    for k, want in r["jax_params"].items():
        g = r["jax_grads"][k]
        sure = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > 1e-4 * gmax)
        np.testing.assert_allclose(r["params"][k][sure], want[sure], rtol=0, atol=1e-6,
                                   err_msg=k)
