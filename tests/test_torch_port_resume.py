"""A port run resumed from a ``com_tpu`` checkpoint follows ``com_tpu``'s own
resumed run, on the CPU.

``com_tpu`` trains 1 epoch of 2 steps on the small synthetic COM config
(``test_torch_port_comaug._loop_cfg``: narrow model, 64x64 grid, f32) with
``ckpt_dir`` and saves (orbax).  The test reads that checkpoint with
``com_tpu.utils.checkpoint.load_checkpoint`` and carries it into a port
``TrainState`` with ``train_state_from_jax`` (weights, Adam's moments and
count, curriculum, sampler).  Then both resume for epoch 1, each over a
fresh loader of its own with one worker: neither package checkpoints the
samplers' round-robin state (ROADMAP Queue 3), so this compares two resumed
runs, not a resumed run against an unbroken one.  The step losses agree to
rtol 1e-5 and the final parameters within ``check_params_after_step``'s
atol 1e-6 for each of the 2 steps taken after the resume (where the last
step's gradient is not rounding noise), the tolerances that
``tests/test_torch_port_train_step.py`` holds one step to.  One JAX jit.
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.loop import train_model as jax_train_model
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.state import TrainState as JaxTrainState
from com_tpu.train.step import device_batch_keys
from com_tpu.train.step import make_train_step as jax_make_train_step
from com_tpu.utils import config as jax_config
from com_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from com_tpu.utils.transfer import host_zeros_like
from com_tpu_torch.data.dataset import build_dataloader
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.loop import train_model
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import make_train_step
from com_tpu_torch.utils import config
from com_tpu_torch.utils.jax_weights import params_from_jax, train_state_from_jax
from test_torch_port_comaug import NAMES, _loop_cfg

torch.set_num_threads(2)
STEPS, EPOCHS = 2, 2  # steps an epoch (4 scenes, batch 2), epochs in all


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("jax_ckpt")
    jcfg, pcfg = _loop_cfg(jax_config), _loop_cfg(config)
    jds, jloader = jax_build_dataloader(jcfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    grid, vsize = tuple(int(g) for g in jds.grid_size), list(jds.voxel_size)
    pc_range = list(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    jmeta = JaxMeta(NAMES, pc_range, vsize, grid, 5)
    keys = device_batch_keys(jcfg.MODEL)
    jnet = jax_build_network(jcfg.MODEL, jmeta)
    pts = np.random.RandomState(0).uniform(-20, 20, (2, 6144, 5)).astype(np.float32)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {"points": pts, "points_mask": np.ones((2, 6144), bool)},
        train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=2)
    tx, _ = jax_build_optimizer(variables["params"], jcfg.OPTIMIZATION, STEPS * EPOCHS, STEPS)
    jstate = JaxTrainState.create_jit(variables, tx, num_head_groups=1, conf_shape=(3, 96))
    jstep = jax.jit(jax_make_train_step(jnet, jcfg.MODEL, NAMES, jmeta, tx, grid[:2]))
    jstate, it = jax_train_model(jstep, jstate, jloader, num_epochs=1, ckpt_dir=ckpt_dir,
                                 batch_keys=keys)
    assert it == STEPS
    payload = jax_load_checkpoint(ckpt_dir / "checkpoint_epoch_1", host_zeros_like(jstate))
    assert int(payload["meta"]["epoch"]) == 1 and int(payload["meta"]["it"]) == STEPS

    # com_tpu resumed
    jds, jloader = jax_build_dataloader(jcfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    jds.set_confidence_groups(payload["sampler"]["confidence_groups"])
    jlosses = []
    jfinal, jit = jax_train_model(jstep, payload["state"], jloader, num_epochs=EPOCHS,
                                  start_epoch=1, start_iter=STEPS, batch_keys=keys,
                                  metric_hook=lambda e, i, m: jlosses.append(float(m["loss"])))

    # the port resumed from the same file
    pmeta = DatasetMeta(NAMES, pc_range, vsize, grid, 5)
    pds, ploader = build_dataloader(pcfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    net = build_network(pcfg.MODEL, pmeta, device="cpu", seed=9)
    opt, _ = build_optimizer(net, pcfg.OPTIMIZATION, STEPS * EPOCHS, STEPS)
    state = TrainState.create(net, opt, 1, (3, 96), device="cpu")
    train_state_from_jax(payload, state, pcfg.MODEL, NAMES, dataset=pds)
    start = {"count": opt.count, "step": state.step,
             "curriculum": [t.clone() for t in state.curriculum[0]],
             "conf": np.array(pds.data_augmentor.gt_sampler.confidence_groups),
             "mu": {k: opt.state[p]["mu"].clone() for k, p in net.named_parameters()}}
    step = make_train_step(net, pcfg.MODEL, NAMES, pmeta, opt, grid[:2], device="cpu")
    plosses = []
    state, pit = train_model(step, state, ploader, EPOCHS, device="cpu", start_epoch=1,
                             start_iter=STEPS, batch_keys=keys,
                             metric_hook=lambda e, i, m: plosses.append(float(m["loss"])))
    return dict(payload=payload, start=start, jlosses=jlosses, plosses=plosses, jit=jit, pit=pit,
                jfinal=jfinal, state=state, cfg=pcfg,
                grads={k: p.grad.numpy().copy() for k, p in net.named_parameters()})


def test_train_state_from_jax_carries_the_checkpoint(resumed):
    """The port starts where the file left off: count and step 2, the
    curriculum and the sampler's confidences as saved, Adam's mu under the
    parameters' layout rules."""
    payload, start = resumed["payload"], resumed["start"]
    js = payload["state"]
    assert start["count"] == start["step"] == int(js.step) == STEPS
    for got, want in zip(start["curriculum"], js.curriculum[0]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_conf = np.asarray(payload["sampler"]["confidence_groups"], np.float32)
    assert start["conf"].tobytes() == want_conf.tobytes() and want_conf.max() > 0
    mu = params_from_jax(js.opt_state[1].inner_state.mu, resumed["cfg"].MODEL, NAMES)
    for k, v in mu.items():
        np.testing.assert_array_equal(start["mu"][k].numpy(), v, err_msg=k)


def test_resumed_runs_agree(resumed):
    assert resumed["jit"] == resumed["pit"] == STEPS * EPOCHS
    jl, pl = resumed["jlosses"], resumed["plosses"]
    assert len(jl) == len(pl) == STEPS and np.isfinite(pl).all()
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    names, cfg = NAMES, resumed["cfg"]
    want = params_from_jax(resumed["jfinal"].params, cfg.MODEL, names)
    got = {k: p.detach().numpy() for k, p in resumed["state"].net.named_parameters()}
    g = resumed["grads"]
    gmax = max(np.abs(v).max() for v in g.values())
    for k, w in want.items():
        sure = (np.abs(g[k]) > 1e-3 * np.abs(g[k]).max()) & (np.abs(g[k]) > 1e-4 * gmax)
        np.testing.assert_allclose(got[k][sure], w[sure], rtol=0, atol=1e-6 * STEPS, err_msg=k)


def test_resume_restarts_the_samplers_round_robin_in_both():
    """Neither package checkpoints the GT samplers' round-robin
    ``pointer``/``indices`` (only their confidences): a loader built afresh
    at epoch 1, as a resumed run builds it, pastes other objects than the
    loader that ran epoch 0 first.  Both packages behave alike, bit for bit
    (ROADMAP Queue 3)."""
    runs = {}
    for name, mod, build in (("jax", jax_config, jax_build_dataloader),
                             ("port", config, build_dataloader)):
        cfg = _loop_cfg(mod)
        _, unbroken = build(cfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
        unbroken.set_epoch(0)
        list(unbroken)
        unbroken.set_epoch(1)
        _, fresh = build(cfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
        fresh.set_epoch(1)
        runs[name] = [[b["gt_boxes"] for b in loader] for loader in (unbroken, fresh)]
    for (j, p) in zip(runs["jax"], runs["port"]):
        assert len(j) == len(p) == STEPS
        for a, b in zip(j, p):
            np.testing.assert_array_equal(a, b)
    unbroken, fresh = runs["port"]
    assert any(not np.array_equal(a, b) for a, b in zip(unbroken, fresh))
