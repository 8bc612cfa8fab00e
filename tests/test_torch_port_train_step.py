"""The port's training slice against the JAX package, end to end on the
CPU, with the COM loss weighting off (the flagship's ``UCL: False``): one
step's loss and loss terms, every gradient, the updated batch statistics,
the curriculum state, the confidence accumulators and the parameters after
the optimizer (setup and tolerances in ``test_torch_port_train_common.py``).
Also the loop's epoch-end feedback and the training entry points' rules.
"""
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.loop import train_model
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, make_train_step
from com_tpu_torch.utils.config import CfgNode

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def result():
    return common.run_slice(ucl=False)


def test_step_loss_matches_jax(result):
    common.check_loss_and_tb(result)


def test_step_gradients_match_jax(result):
    common.check_grads(result)


def test_step_state_matches_jax(result):
    common.check_state(result)


def test_step_parameters_match_jax(result):
    common.check_params_after_step(result)


class _Dataset:
    def __init__(self):
        self.received = []

    def set_confidence_groups(self, conf):
        self.received.append(np.array(conf))


class _Loader:
    """The duck-typed loader ``train_model`` needs: set_epoch, iteration over
    dicts of numpy arrays, dataset.set_confidence_groups."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at
        self.dataset = _Dataset()
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise OSError("disk gone")
            yield b


def _tiny_setup():
    """The flagship's head and losses over a narrow backbone at a 32x32 grid."""
    cfg = common.tiny_cfg()
    names = list(cfg.CLASS_NAMES)
    meta = DatasetMeta(names, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0), (0.32, 0.32, 6.0),
                       (32, 32, 1), 5)
    net = build_network(cfg.MODEL, meta, device="cpu", seed=1)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 20, 2)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device="cpu")
    step = make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device="cpu")
    return cfg, meta, net, opt, state, step


def test_train_model_feeds_confidences_back_each_epoch():
    cfg, meta, net, opt, state, step = _tiny_setup()
    batches = [common.tiny_batch(np.random.RandomState(i)) for i in range(2)]
    loader = _Loader(batches)
    seen = []
    state, iters = train_model(step, state, loader, num_epochs=2, device="cpu",
                               metric_hook=lambda e, it, m: seen.append(m))
    assert iters == 4 and loader.epochs == [0, 1] and state.step == 4
    assert np.isfinite([float(m["loss"]) for m in seen]).all()
    assert len(loader.dataset.received) == 2
    for conf in loader.dataset.received:
        assert conf.shape == (3, 96) and np.isfinite(conf).all() and conf.max() > 0
    # the accumulators restart each epoch: the last feedback is epoch 1's alone
    cnt = seen[2]["confidence_cnt"] + seen[3]["confidence_cnt"]
    assert torch.equal(state.conf_cnt, cnt) and float(cnt.sum()) > 0
    np.testing.assert_allclose(loader.dataset.received[-1],
                               (state.conf_sum / (state.conf_cnt + 0.01)).numpy(), rtol=1e-6)


def test_train_model_fails_when_the_loader_fails(tmp_path):
    cfg, meta, net, opt, state, step = _tiny_setup()
    loader = _Loader([common.tiny_batch(np.random.RandomState(0))] * 3, fail_at=1)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        train_model(step, state, loader, num_epochs=1, device="cpu")
    assert loader.dataset.received == []  # no feedback from a truncated epoch
    # nor a checkpoint of it
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        train_model(step, state, loader, num_epochs=1, ckpt_dir=tmp_path, device="cpu")
    assert loader.dataset.received == [] and list(tmp_path.iterdir()) == []


def test_training_entry_points_need_a_device(monkeypatch):
    cfg, meta, net, opt, state, step = _tiny_setup()
    names = list(cfg.CLASS_NAMES)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainState.create(net, opt, 1, (3, 96))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_model(step, state, _Loader([]), num_epochs=1)
    with pytest.raises(ValueError, match="the model is on cpu"):
        make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device="meta")


@pytest.mark.parametrize("slot", ["ANCHOR_GENERATOR_CONFIG", "ROI_HEAD", "POINT_HEAD"])
def test_unported_loss_branches_raise(slot):
    cfg, meta, net, opt, state, step = _tiny_setup()
    model_cfg = CfgNode(dict(cfg.MODEL))
    if slot == "ANCHOR_GENERATOR_CONFIG":  # the anchor loss is ported; its ATSS assigner is not
        model_cfg.DENSE_HEAD = CfgNode(dict(model_cfg.DENSE_HEAD, ANCHOR_GENERATOR_CONFIG=[],
                                            TARGET_ASSIGNER_CONFIG={"NAME": "ATSSTargetAssigner"}))
    else:
        model_cfg[slot] = {"NAME": "x"}
    with pytest.raises(NotImplementedError):
        make_train_step(net, model_cfg, list(cfg.CLASS_NAMES), meta, opt, (32, 32), device="cpu")
