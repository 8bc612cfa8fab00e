"""Checkpoints of the port (``com_tpu_torch/utils/checkpoint.py``), on the CPU:
the counterparts of the four cases of ``tests/test_checkpoint.py`` (round
trip and prune, a corrupt newest file skipped, ``latest_model`` rolling and
resuming, ``load_params_only`` skipping mismatches, also from a
reference-style ``.pth``), the whole train state round-tripped bitwise
through a file that loads with ``weights_only=True``, the optimizer's step
count carried so that a resumed optimizer's next update equals that of one
never saved, and ``train_model`` writing epoch checkpoints with the
sampler's confidences.  The state is the flagship's head over a narrow
backbone at a 32x32 grid (``test_torch_port_train_common.tiny_cfg``)."""
import argparse
import copy
import logging

import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu_torch.losses.curriculum import CurriculumState
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.loop import train_model
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, make_train_step
from com_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)


def _setup(seed=1, steps=2):
    """A tiny trainer after ``steps`` steps: moments, count, curriculum and
    accumulators all away from their initial values."""
    cfg = common.tiny_cfg()
    names = list(cfg.CLASS_NAMES)
    meta = DatasetMeta(names, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0), (0.32, 0.32, 6.0),
                       (32, 32, 1), 5)
    net = build_network(cfg.MODEL, meta, device="cpu", seed=seed)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 20, 2)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device="cpu")
    step = make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device="cpu")
    for i in range(steps):
        state, _ = step(state, common.tiny_batch(np.random.RandomState(i)), 0)
    return cfg, meta, state, step


def _snapshot(state):
    """Every tensor of a state, copied, with the host numbers."""
    opt = state.optimizer
    return {"model": {k: v.clone() for k, v in state.net.state_dict().items()},
            "moments": [{k: v.clone() for k, v in opt.state[p].items()}
                        for g in opt.param_groups for p in g["params"]],
            "count": opt.count, "step": state.step,
            "curriculum": [[t.clone() for t in c] for c in state.curriculum],
            "conf": (state.conf_sum.clone(), state.conf_cnt.clone())}


def _assert_bitwise(a, b):
    assert a["count"] == b["count"] and a["step"] == b["step"]
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert len(a["moments"]) == len(b["moments"])
    for x, y in zip(a["moments"], b["moments"]):
        assert sorted(x) == ["mu", "nu"] and all(torch.equal(x[k], y[k]) for k in x)
    for x, y in zip(a["curriculum"], b["curriculum"]):
        assert all(torch.equal(s, t) and s.dtype == t.dtype for s, t in zip(x, y))
    assert all(torch.equal(s, t) for s, t in zip(a["conf"], b["conf"]))


def test_roundtrip_and_prune(tmp_path):
    """Save epochs 1..4 with a cap of 2: epochs 3 and 4 remain; resume the
    newest into a fresh state bitwise (model, moments, count, curriculum,
    accumulators, sampler), from a file ``weights_only=True`` reads."""
    _, _, state, _ = _setup()
    state.curriculum = (CurriculumState(torch.tensor(0.25), torch.tensor(0.5), torch.tensor(0.1),
                                        torch.tensor(True)),)
    conf = np.arange(288, dtype=np.float32).reshape(3, 96) / 7
    for epoch in range(1, 5):
        ckpt.save_checkpoint(state, tmp_path, epoch, epoch * 100,
                             sampler_state={"confidence_groups": conf}, max_ckpt_save_num=2)
    assert [e for e, _ in ckpt._ckpt_files(tmp_path)] == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_3.pth",
                                                         "checkpoint_epoch_4.pth"]
    torch.load(tmp_path / "checkpoint_epoch_4.pth", weights_only=True)

    _, _, fresh, _ = _setup(seed=5, steps=0)
    payload = ckpt.resume_latest(tmp_path, fresh)
    assert payload["epoch"] == 4 and payload["it"] == 400
    assert payload["version"] == ckpt.VERSION
    _assert_bitwise(_snapshot(fresh), _snapshot(state))
    got = ckpt.sampler_confidences(payload)
    assert got.dtype == np.float32 and got.tobytes() == conf.tobytes()


def test_resume_skips_corrupted(tmp_path):
    _, _, state, _ = _setup(steps=1)
    ckpt.save_checkpoint(state, tmp_path, 1, 100)
    ckpt.save_checkpoint(state, tmp_path, 2, 200)
    (tmp_path / "checkpoint_epoch_2.pth").write_bytes(b"not a checkpoint")
    payload = ckpt.resume_latest(tmp_path, logger=logging.getLogger("test"))
    assert payload is not None and payload["epoch"] == 1
    (tmp_path / "checkpoint_epoch_1.pth").write_bytes(b"")
    assert ckpt.resume_latest(tmp_path) is None


def test_latest_model_rolls_and_resumes(tmp_path):
    """The rolling ``latest_model.pth``: overwritten in place, never pruned,
    and it outranks the epoch files until a newer epoch is saved."""
    _, _, state, step = _setup(steps=1)
    ckpt.save_checkpoint(state, tmp_path, 1, 10)
    ckpt.save_latest(state, tmp_path, 1, 30)
    ckpt.save_latest(state, tmp_path, 1, 37)
    assert ckpt.resume_latest(tmp_path)["it"] == 37
    ckpt.save_checkpoint(state, tmp_path, 2, 50, max_ckpt_save_num=1)
    assert ckpt.resume_latest(tmp_path)["it"] == 50
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint_epoch_2.pth",
                                                         "latest_model.pth"]


def test_load_params_only_skips_mismatches(tmp_path):
    """``--pretrained_model``: matching tensors load, a shape mismatch and an
    absent key keep the fresh value; a reference-style ``.pth`` (a
    ``model_state`` beside pickled objects) loads too."""
    _, _, src, _ = _setup(seed=2, steps=1)
    sd = src.net.state_dict()
    key, wrong = "dense_head.shared_conv.0.weight", "dense_head.heads_list.0.hm.1.bias"
    ref = {"model_state": {k: v for k, v in sd.items() if k != key},
           "optimizer_state": {"opt": argparse.Namespace(lr=0.003)},  # not weights-only
           "epoch": 3, "it": 30, "version": "pcdet+0.6.0"}
    ref["model_state"][wrong] = torch.zeros(7)
    torch.save(ref, tmp_path / "ref.pth")
    _, _, dst, _ = _setup(seed=3, steps=0)
    before = copy.deepcopy(dst.net.state_dict())
    loaded, skipped = ckpt.load_params_only(tmp_path / "ref.pth", dst.net,
                                            logger=logging.getLogger("t"))
    own = dst.net.state_dict()
    assert skipped == 1 and loaded == len(own) - 2
    assert torch.equal(own[key], before[key]) and torch.equal(own[wrong], before[wrong])
    for k, v in own.items():
        if k not in (key, wrong):
            assert torch.equal(v, sd[k]), k
    ckpt.save_checkpoint(src, tmp_path, 1, 10)
    _, _, dst, _ = _setup(seed=3, steps=0)
    assert ckpt.load_params_only(tmp_path / "checkpoint_epoch_1.pth", dst.net) == (len(sd), 0)


def test_resumed_optimizer_steps_as_one_never_saved(tmp_path):
    """``AdamOneCycle.state_dict`` carries ``count``: a fresh optimizer loaded
    from it takes the next update bitwise like the one that was saved (the
    one-cycle schedules and the bias correction continue at count 3)."""
    _, _, state, step = _setup(steps=3)
    assert state.optimizer.count == 3 and state.optimizer.state_dict()["count"] == 3
    ckpt.save_checkpoint(state, tmp_path, 1, 3)
    _, _, fresh, fresh_step = _setup(seed=4, steps=0)
    ckpt.load_checkpoint(tmp_path / "checkpoint_epoch_1.pth", fresh)
    assert fresh.optimizer.count == 3
    batch = common.tiny_batch(np.random.RandomState(9))
    state, _ = step(state, batch, 0)
    fresh, _ = fresh_step(fresh, batch, 0)
    _assert_bitwise(_snapshot(fresh), _snapshot(state))
    with pytest.raises(KeyError, match="count"):
        sd = fresh.optimizer.state_dict()
        del sd["count"]
        fresh.optimizer.load_state_dict(sd)


class _Sampler:
    def __init__(self):
        self.confidence_groups = None


class _Dataset:
    def __init__(self):
        self.data_augmentor = argparse.Namespace(gt_sampler=_Sampler())

    def set_confidence_groups(self, conf):
        self.data_augmentor.gt_sampler.confidence_groups = conf


class _Loader:
    def __init__(self, batches):
        self.batches, self.dataset = batches, _Dataset()

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def test_train_model_saves_and_resumes_epochs(tmp_path):
    """``train_model(ckpt_dir=...)``: a checkpoint each epoch, pruned, holding
    the iteration and the sampler's confidences of that epoch; a run started
    from it continues the count of iterations."""
    _, _, state, step = _setup(steps=0)
    loader = _Loader([common.tiny_batch(np.random.RandomState(i)) for i in range(2)])
    state, it = train_model(step, state, loader, 2, ckpt_dir=tmp_path, device="cpu",
                            max_ckpt_save_num=1)
    assert it == 4 and [e for e, _ in ckpt._ckpt_files(tmp_path)] == [2]
    payload = ckpt.load_checkpoint(tmp_path / "checkpoint_epoch_2.pth")
    held = loader.dataset.data_augmentor.gt_sampler.confidence_groups
    assert payload["it"] == 4 and payload["step"] == 4
    assert ckpt.sampler_confidences(payload).tobytes() == held.tobytes()
    state, it = train_model(step, state, loader, 3, ckpt_dir=tmp_path, device="cpu",
                            start_epoch=2, start_iter=4)
    assert it == 6 and ckpt.load_checkpoint(tmp_path / "checkpoint_epoch_3.pth")["it"] == 6


def test_explicit_cuda_needs_a_card(monkeypatch):
    from com_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
