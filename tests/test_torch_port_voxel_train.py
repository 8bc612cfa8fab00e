"""One CenterPoint-voxel train step with COMLoss (UCL on) through both
packages on the CPU, at ``test_torch_port_voxel_model.py``'s scenes and
narrowed config (64 x 64 x 40 grid, f32), held to the train-step tests'
tolerances (``test_torch_port_train_common``); then a JAX TrainState one
Adam update on, carried into the port by ``train_state_from_jax``.  One
JAX jit of the loss and its gradient.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import test_torch_port_train_common as common
from com_tpu.train.state import TrainState as JaxTrainState
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for
from com_tpu_torch.utils.jax_weights import _optax_leaves, params_from_jax, train_state_from_jax
from test_torch_port_voxel_model import VOXEL_CFG, VOXEL_KEYS, metas, narrow, scenes

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def test_centerpoint_voxel_comloss_train_step_matches_jax():
    """One COMLoss step (UCL on) at the train-step tests' tolerances: loss
    and its terms, every gradient, the batch statistics, the curriculum
    state and the confidence accumulators, the parameters after Adam; then
    the JAX state after that update carried in by ``train_state_from_jax``."""
    host, pc_range, vsize = scenes(seed=6)
    cfg = narrow(cfg_from_yaml_file(str(REPO / VOXEL_CFG)))
    assert cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL
    jmeta, _ = metas(cfg, pc_range, vsize)
    r = common.run_step_pair(cfg, jmeta, host, VOXEL_KEYS)
    common.check_loss_and_tb(r)
    common.check_grads(r)
    common.check_state(r)
    common.check_params_after_step(r)
    assert any(k.startswith("backbone_3d.") for k in r["grads"])

    # a JAX TrainState one Adam update on -> the port's TrainState
    names = r["names"]
    jstate = JaxTrainState.create(r["variables"], r["tx"], num_head_groups=1,
                                  conf_shape=(3, 96))
    _, opt_state = r["tx"].update(r["jgrads"], jstate.opt_state, r["variables"]["params"])
    jstate = jstate.replace(step=jnp.int32(1), opt_state=opt_state)
    net = build_network(cfg.MODEL, metas(cfg, pc_range, vsize)[1], device="cpu", seed=3)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device="cpu")
    train_state_from_jax({"state": jstate}, state, cfg.MODEL, names)
    assert state.step == opt.count == 1
    adam = []
    _optax_leaves(opt_state, adam, [])
    mu = params_from_jax(adam[0]["mu"], cfg.MODEL, names)
    for k, p in net.named_parameters():
        np.testing.assert_array_equal(opt.state[p]["mu"].numpy(), mu[k], err_msg=k)
    w = "backbone_3d.conv2.0.0.weight"
    np.testing.assert_array_equal(net.state_dict()[w].numpy(), params_from_jax(
        r["variables"]["params"], cfg.MODEL, names)[w])


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def test_voxel_config_through_train_and_test_clis(tmp_path):
    """The train CLI (1 epoch of 2 steps) and the test CLI on its checkpoint
    over the voxel config narrowed, the synthetic dataset's scenes (4 of
    1,500 ground points, COM GT-paste) hard-voxelized by the port's native
    voxelizer at the 64 x 64 x 40 grid: the stride-8 heatmap (8 x 8) trains
    and evaluates."""
    import yaml

    from com_tpu_torch.tools import test, train

    model = narrow(cfg_from_yaml_file(str(REPO / VOXEL_CFG)))
    data = cfg_from_yaml_file(str(REPO / "configs/synthetic_models/centerpoint_synth_com.yaml"))
    d = _plain(data.DATA_CONFIG)
    d.update(NUM_SCENES=4, NUM_OBJECTS=6, NUM_BG_POINTS=1500, MAX_POINTS_PER_SCENE=6144,
             MAX_GT_OBJECTS=16, POINT_CLOUD_RANGE=[-16.0, -16.0, -2.0, 16.0, 16.0, 2.0])
    d["DATA_PROCESSOR"] = _plain(model.DATA_CONFIG.DATA_PROCESSOR)
    d["DATA_PROCESSOR"][2].update(VOXEL_SIZE=[0.5, 0.5, 0.1],
                                  MAX_NUMBER_OF_VOXELS={"train": 2048, "test": 2048})
    path = tmp_path / "voxel.yaml"
    path.write_text(yaml.safe_dump({"CLASS_NAMES": list(model.CLASS_NAMES), "DATA_CONFIG": d,
                                    "MODEL": _plain(model.MODEL),
                                    "OPTIMIZATION": _plain(model.OPTIMIZATION)}))
    base = ["--cfg_file", str(path), "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "out")]
    first = train.main(base + ["--epochs", "1", "--batch_size", "2", "--seed", "3"])
    assert first["iterations"] == 2
    hm = first["state"].net.dense_head.heads_list[0].hm  # the stride-8 map's head
    assert all(torch.isfinite(p).all() for p in hm.parameters())
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    (res,) = test.main(base + ["--ckpt", str(ckpt), "--batch_size", "2"])
    assert len(res["det_annos"]) == 4
    for a in res["det_annos"]:
        assert np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
        assert set(a["pred_labels"]) <= {1, 2, 3}
