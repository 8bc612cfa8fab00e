"""The COMAug samplers and the closed curriculum loop of the port against the
JAX package, on the CPU.

* The samplers (``DataBaseSampler``, ``V2``, ``COM1``, ``COM2``) draw the
  same database entries in the same order as ``com_tpu``'s over several
  calls and epochs with the same injected confidences, and paste the same
  scenes: confidences None, an epoch past ``AVE``, ``STOP``, ``BACK``,
  ``ANTI: False``, ``LIMIT_WHOLE_SCENE`` on and off.
* The closed loop: both packages train 2 epochs x 2 steps on a small
  ``centerpoint_synth_com.yaml`` (narrow model, 64x64 grid, f32) from the
  same weights (the JAX variables perturbed from a seed, norm biases moved
  up by 3, carried over by the weight bridge), each over its own loader with
  one worker.  The confidences each loop hands its sampler agree within the
  train step's tolerance (``test_torch_port_train_common.check_state``:
  rtol 1e-5, atol 1e-5 on the sums; the counts exactly), and with
  ``com_tpu``'s confidences injected into both, epoch 1's batches are
  bit-equal.  One JAX jit.
"""
import copy

import jax
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.data.augmentor import database_sampler as jax_ds
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu.data.synthetic import make_scene as jax_make_scene
from com_tpu.data.synthetic import make_synthetic_db_infos as jax_make_db
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.loop import train_model as jax_train_model
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.state import TrainState as JaxTrainState
from com_tpu.train.step import device_batch_keys as jax_batch_keys
from com_tpu.train.step import make_train_step as jax_make_train_step
from com_tpu.utils import config as jax_config
from com_tpu_torch.data.augmentor import database_sampler as port_ds
from com_tpu_torch.data.dataset import build_dataloader
from com_tpu_torch.data.synthetic import make_scene, make_synthetic_db_infos
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.loop import train_model
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import device_batch_keys, make_train_step
from com_tpu_torch.utils import config
from com_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(2)
NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
SYNTH = "configs/synthetic_models/centerpoint_synth_com.yaml"
PC_RANGE = [-74.88, -74.88, -2.0, 74.88, 74.88, 4.0]


# ---------------------------------------------------------------- samplers

def _sampler_cfg(kind, **extra):
    cfg = {"SAMPLE_GROUPS": ["Vehicle:6", "Pedestrian:4", "Cyclist:4"],
           "NUM_POINT_FEATURES": 5, "REMOVE_EXTRA_WIDTH": [0.1, 0.1, 0.1],
           "PREPARE": {"filter_by_min_points": ["Vehicle:5", "Pedestrian:5", "Cyclist:5"],
                       "filter_by_difficulty": [-1]},
           "LIMIT_WHOLE_SCENE": False}
    if kind != "base":
        cfg.update(USE_CURRICULUM_AUG=True, COM=kind == "com2", V2=kind == "v2",
                   M3=[3.0, 0.5, 0.5], S3=[0.2, 0.2, 0.2], ANTI=True, BACK=False, STOP=100)
    cfg.update(extra)
    return cfg


def _db():
    return make_synthetic_db_infos(np.random.RandomState(4), NAMES, per_class=48)


def _scene(i):
    s = make_scene(np.random.RandomState(100 + i), NAMES, num_objects=8, num_bg_points=3000,
                   pc_range=PC_RANGE)
    s["gt_boxes_mask"] = np.ones(len(s["gt_names"]), bool)
    return s


def _confidences(seed):
    rng = np.random.RandomState(seed)
    conf = rng.uniform(0.0, 0.6, (3, 96)).astype(np.float32)
    conf[:, 15:][1:] = 0.0  # Pedestrian/Cyclist have 15 groups
    return conf


SAMPLER_CASES = {
    "base": ("base", {}, [(0, None)] * 3),
    "base_limit_whole_scene": ("base", {"LIMIT_WHOLE_SCENE": True}, [(0, None)] * 3),
    "v2": ("v2", {}, [(0, None), (1, 1), (2, 2)]),
    "com1": ("com1", {}, [(0, None), (1, 1), (2, 2)]),
    "com2_no_confidence": ("com2", {}, [(0, None), (1, None), (2, None)]),
    "com2_anti": ("com2", {}, [(0, None), (1, 1), (2, 2), (5, 3)]),
    "com2_not_anti": ("com2", {"ANTI": False}, [(1, 1), (2, 2), (9, 3)]),
    "com2_past_ave": ("com2", {"AVE": 3}, [(3, 1), (4, 2), (6, 3)]),
    "com2_stop": ("com2", {"STOP": 2}, [(1, 1), (2, 2), (3, 3)]),
    "com2_back": ("com2", {"BACK": True}, [(2, 1), (27, 2), (30, 3)]),
    "com2_limit_whole_scene": ("com2", {"LIMIT_WHOLE_SCENE": True}, [(1, 1), (2, 2)]),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_draws_and_pastes_match_jax(case):
    """Each (epoch, confidences) step: two scenes through both samplers from
    one RandomState each; the drawn entries (by identity in the shared
    database), the group probabilities and the pasted scenes are equal."""
    kind, extra, schedule = SAMPLER_CASES[case]
    db = _db()
    samplers = []
    for mod in (jax_ds, port_ds):
        sampler = mod.build_gt_sampler(None, _sampler_cfg(kind, **extra), NAMES, db_infos=db,
                                       rng=np.random.RandomState(7))
        drawn = []

        def spy(class_name, group, _orig=sampler._sample_for_class, _drawn=drawn):
            out = _orig(class_name, group)
            _drawn.append([id(x) for x in out])
            return out
        sampler._sample_for_class = spy
        samplers.append((sampler, drawn))
    (js, jd), (ps, pd) = samplers
    assert type(ps).__name__ == type(js).__name__
    for call, (epoch, conf_seed) in enumerate(schedule):
        conf = None if conf_seed is None else _confidences(conf_seed)
        for s in (js, ps):
            s.epoch, s.confidence_groups = epoch, conf
        if hasattr(js, "group_probability"):
            for c in NAMES:
                jp = js.group_probability(c, js.sample_groups[c])
                pp = ps.group_probability(c, ps.sample_groups[c])
                assert (jp is None) == (pp is None)
                if jp is not None:
                    np.testing.assert_array_equal(pp, jp)
        for i in range(2):
            scene = _scene(2 * call + i)
            outs = [s(copy.deepcopy(scene)) for s in (js, ps)]
            assert sorted(outs[0]) == sorted(outs[1])
            for k, v in outs[0].items():
                np.testing.assert_array_equal(outs[1][k], v, err_msg=f"{case} {k}")
    assert pd == jd and sum(len(d) for d in jd) > 0
    if case == "com2_stop":  # nothing pasted once STOP is reached
        assert all(not d for d in jd[2 * len(NAMES):]) and any(jd[:2 * len(NAMES)])


def test_com2_pacing_and_groups():
    """``pacing`` (the port's read-out of COM2's k and centre u) is the k and
    u ``group_probability`` uses, and the Gaussian weights move the draw
    away from the size shares."""
    s = port_ds.build_gt_sampler(None, _sampler_cfg("com2"), NAMES, db_infos=_db(),
                                 rng=np.random.RandomState(0))
    s.confidence_groups, s.epoch = _confidences(5), 2
    for ci, c in enumerate(NAMES):
        sizes = np.array([len(g) for g in s.sample_groups[c]["indices"]], np.float64)
        k, u, conf = s.pacing(c, len(sizes))
        assert k == min(int(2 * s.m3[ci]), len(sizes) - 1)
        assert u == np.sort(conf)[k]
        sigma = np.sqrt(s.s3[ci])
        w = np.exp(-((conf - u) ** 2) / (2 * sigma ** 2)) / (np.sqrt(2 * np.pi) * sigma)
        w = w * sizes / sizes.sum()
        np.testing.assert_allclose(s.group_probability(c, s.sample_groups[c]), w / w.sum(),
                                   rtol=1e-12)
        assert np.abs(w / w.sum() - sizes / sizes.sum()).max() > 1e-3


def test_unported_sampler_options_raise():
    """The KITTI image copy-paste and ``USE_ROAD_PLANE``, which raised until
    they were ported, build (``test_torch_port_kitti_images.py`` and
    ``test_torch_port_kitti.py`` hold them to ``com_tpu``)."""
    sampler = port_ds.build_gt_sampler(None, _sampler_cfg("base", IMG_AUG_TYPE="kitti",
                                                          IMG_AUG_IOU_THRESH=0.3), NAMES,
                                       db_infos=_db())
    assert (sampler.img_aug_type, sampler.img_aug_iou_thresh) == ("kitti", 0.3)
    sampler = port_ds.build_gt_sampler(None, _sampler_cfg("base", USE_ROAD_PLANE=True), NAMES,
                                       db_infos=_db())
    assert sampler.sampler_cfg["USE_ROAD_PLANE"] is True


def test_same_synthetic_scenes_and_database():
    """Both packages make the same scenes and GT database from one seed."""
    for fn_j, fn_p, kw in ((jax_make_scene, make_scene, {"num_bg_points": 500}),
                           (jax_make_db, make_synthetic_db_infos, {"per_class": 8})):
        a, b = fn_j(np.random.RandomState(3), NAMES, **kw), fn_p(np.random.RandomState(3),
                                                                  NAMES, **kw)
        if fn_p is make_scene:
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
        else:
            for c in NAMES:
                for x, y in zip(a[c], b[c]):
                    assert sorted(x) == sorted(y)
                    for k in x:
                        np.testing.assert_array_equal(y[k], x[k])


# ------------------------------------------------------------- closed loop

def _loop_cfg(mod):
    """The synthetic COM config, small: 6 scenes of 1,500 ground points and
    up to 8 objects over +-25.6 m (0.8 m pillars: 64x64), a 6,144-point and
    48-object cap, and a narrow one-block backbone in f32."""
    cfg = mod.cfg_from_yaml_file(SYNTH)
    d = cfg.DATA_CONFIG
    d.NUM_SCENES, d.NUM_BG_POINTS, d.NUM_OBJECTS = 4, 1500, 8
    d.POINT_CLOUD_RANGE = [-25.6, -25.6, -2.0, 25.6, 25.6, 4.0]
    d.MAX_POINTS_PER_SCENE, d.MAX_GT_OBJECTS = 6144, 48
    vox = d.DATA_PROCESSOR[2]
    vox.VOXEL_SIZE = [0.8, 0.8, 6.0]
    vox.MAX_NUMBER_OF_VOXELS = {"train": 4096, "test": 4096}
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.VFE.NUM_FILTERS = [16, 16]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1], LAYER_STRIDES=[1], NUM_FILTERS=[16],
                         UPSAMPLE_STRIDES=[1], NUM_UPSAMPLE_FILTERS=[16])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 48
    return cfg


class _Recorder:
    """The loader as train_model reads it, recording the confidences handed
    to the sampler and the host batches of each epoch."""

    def __init__(self, loader):
        self.loader, self.dataset, self.conf, self.batches = loader, self, [], {}
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def set_confidence_groups(self, conf):
        self.conf.append(np.array(conf))
        self.loader.dataset.set_confidence_groups(conf)

    def __iter__(self):
        for b in self.loader:
            self.batches.setdefault(self.epoch, []).append(b)
            yield b


@pytest.fixture(scope="module")
def loops():
    jcfg, pcfg = _loop_cfg(jax_config), _loop_cfg(config)
    jds, jloader = jax_build_dataloader(jcfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    pds, ploader = build_dataloader(pcfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    grid, vsize = tuple(int(g) for g in jds.grid_size), list(jds.voxel_size)
    assert grid == (64, 64, 1) and tuple(pds.grid_size) == grid
    pc_range = list(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    jmeta = JaxMeta(NAMES, pc_range, vsize, grid, 5)
    pmeta = DatasetMeta(NAMES, pc_range, vsize, grid, 5)
    keys = jax_batch_keys(jcfg.MODEL)
    assert device_batch_keys(pcfg.MODEL) == keys

    jnet = jax_build_network(jcfg.MODEL, jmeta)
    # init from a made-up batch: reading the datasets here would move their
    # samplers' round-robin state ahead of the loop
    pts = np.random.RandomState(0).uniform(-20, 20, (2, 6144, 5)).astype(np.float32)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {"points": pts, "points_mask": np.ones((2, 6144), bool)},
        train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=2)
    total, per_epoch = 4, 2
    tx, _ = jax_build_optimizer(variables["params"], jcfg.OPTIMIZATION, total, per_epoch)
    jstate = JaxTrainState.create_jit(variables, tx, num_head_groups=1, conf_shape=(3, 96))
    jstep = jax.jit(jax_make_train_step(jnet, jcfg.MODEL, NAMES, jmeta, tx, grid[:2]))
    jrec = _Recorder(jloader)
    jax_train_model(jstep, jstate, jrec, num_epochs=2, batch_keys=keys)

    net = build_network(pcfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, pcfg.MODEL, NAMES)
    opt, _ = build_optimizer(net, pcfg.OPTIMIZATION, total, per_epoch)
    state = TrainState.create(net, opt, 1, (3, 96), device="cpu")
    step = make_train_step(net, pcfg.MODEL, NAMES, pmeta, opt, grid[:2], device="cpu")
    prec = _Recorder(ploader)
    _, steps = train_model(step, state, prec, num_epochs=2, device="cpu", batch_keys=keys)
    assert steps == 4
    return dict(jcfg=jcfg, pcfg=pcfg, jrec=jrec, prec=prec, jds=jds, pds=pds)


def test_closed_loop_confidences_match_jax(loops):
    """Each epoch's (3, 96) confidences, ``conf_sum / (conf_cnt + 0.01)``,
    agree within the train step's tolerance: the sums to rtol 1e-5 and
    atol 1e-5, so the ratio within 1e-5 relative plus 1e-5 over the count."""
    jconf, pconf = loops["jrec"].conf, loops["prec"].conf
    assert len(jconf) == len(pconf) == 2
    for e, (j, p) in enumerate(zip(jconf, pconf)):
        assert p.shape == j.shape == (3, 96) and p.dtype == np.float32
        assert j.max() > 0, e
        np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5, err_msg=f"epoch {e}")
    for rec in ("jrec", "prec"):  # each sampler holds what its loop handed it
        held = loops[rec.replace("rec", "ds")].data_augmentor.gt_sampler.confidence_groups
        np.testing.assert_array_equal(held, loops[rec].conf[-1])


def test_closed_loop_epoch0_batches_match(loops):
    """Epoch 0 (no confidences yet): the two loops trained on equal batches."""
    _assert_batches_equal(loops["jrec"].batches[0], loops["prec"].batches[0])


def test_injected_confidences_give_equal_next_epoch(loops):
    """With ``com_tpu``'s epoch-0 confidences injected into both packages'
    fresh loaders, epoch 1's batches are bit-equal, and differ from a draw
    without confidences."""
    conf = loops["jrec"].conf[0]
    runs = []
    for build, cfg in ((jax_build_dataloader, loops["jcfg"]),
                       (build_dataloader, loops["pcfg"])):
        ds, loader = build(cfg.DATA_CONFIG, NAMES, 2, seed=3, workers=1)
        loader.set_epoch(1)
        ds.set_confidence_groups(conf)
        runs.append(list(loader))
    _assert_batches_equal(*runs)
    ds, loader = build_dataloader(loops["pcfg"].DATA_CONFIG, NAMES, 2, seed=3, workers=1)
    loader.set_epoch(1)
    plain = list(loader)
    assert any(not np.array_equal(a["gt_boxes"], b["gt_boxes"]) for a, b in zip(plain, runs[1]))


def _assert_batches_equal(ja, pa):
    assert len(ja) == len(pa) > 0
    for jb, pb in zip(ja, pa):
        assert sorted(jb) == sorted(pb)
        for k, v in jb.items():
            if isinstance(v, np.ndarray):
                assert pb[k].dtype == v.dtype, k
                np.testing.assert_array_equal(pb[k], v, err_msg=k)
            else:
                assert pb[k] == v, k
