"""The port's train, test and demo CLIs (``com_tpu_torch/tools``) in-process on
the CPU, on ``configs/synthetic_models/centerpoint_synth_com.yaml`` shrunk
through ``--set`` (4 scenes of 1,500 ground points over +-25.6 m at 0.8 m
pillars, a narrow one-block model, f32): train 2 epochs with one checkpoint
kept, resume to 3 (it starts at epoch 2, iteration 4, with the file's
optimizer count), test the newest checkpoint with ``--infer_time`` and
``--save_to_file``, poll the directory with ``--eval_all`` (its sleep
patched out), and run the demo on two ``.npy`` scenes.  The flags of several
cards raise, and ``--device`` defaults to ``cuda``, which raises without a
card."""
import json
import pickle

import numpy as np
import pytest
import torch

from com_tpu_torch.data.synthetic import make_scene
from com_tpu_torch.tools import demo, test, train
from com_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(2)
CFG = "configs/synthetic_models/centerpoint_synth_com.yaml"
SMALL = ["DATA_CONFIG.NUM_SCENES", "4", "DATA_CONFIG.NUM_BG_POINTS", "1500",
         "DATA_CONFIG.POINT_CLOUD_RANGE", "[-25.6,-25.6,-2.0,25.6,25.6,4.0]",
         "DATA_CONFIG.MAX_POINTS_PER_SCENE", "6144", "DATA_CONFIG.MAX_GT_OBJECTS", "48",
         "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[0.8,0.8,6.0]",
         "MODEL.MIXED_PRECISION", "False", "MODEL.VFE.NUM_FILTERS", "[16,16]",
         "MODEL.MAP_TO_BEV.NUM_BEV_FEATURES", "16", "MODEL.BACKBONE_2D.LAYER_NUMS", "[1]",
         "MODEL.BACKBONE_2D.LAYER_STRIDES", "[1]", "MODEL.BACKBONE_2D.NUM_FILTERS", "[16]",
         "MODEL.BACKBONE_2D.UPSAMPLE_STRIDES", "[1]",
         "MODEL.BACKBONE_2D.NUM_UPSAMPLE_FILTERS", "[16]",
         "MODEL.DENSE_HEAD.SHARED_CONV_CHANNEL", "16",
         "MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS", "48"]


def _args(out, *extra, device=("--device", "cpu")):
    return ["--cfg_file", CFG, *device, "--workers", "1", "--output_dir", str(out), *extra,
            "--set", *SMALL]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    first = train.main(_args(out, "--epochs", "2", "--max_ckpt_save_num", "1", "--seed", "3",
                             "--logger_iter_interval", "1"))
    kept = sorted(p.name for p in first["ckpt_dir"].iterdir())
    seen = {}

    def on_start(info):
        opt = info["state"].optimizer
        seen.update(epoch=info["start_epoch"], it=info["start_iter"], count=opt.count,
                    conf=np.array(info["dataset"].data_augmentor.gt_sampler.confidence_groups),
                    payload=info["payload"])

    second = train.main(_args(out, "--epochs", "3", "--seed", "3"), on_start=on_start)
    return dict(out=out, first=first, kept=kept, second=second, seen=seen)


def test_train_writes_prunes_and_logs(runs):
    first = runs["first"]
    assert first["iterations"] == 4 and first["start_epoch"] == 0
    assert runs["kept"] == ["checkpoint_epoch_2.pth"]
    tag = runs["out"] / "synthetic_models" / "centerpoint_synth_com"
    assert first["out_dir"] == tag / "default"
    assert list(first["out_dir"].glob("log_train_*.txt"))
    lines = [json.loads(x) for x in
             (first["out_dir"] / "metrics" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines[:4]] == [0, 1, 2, 3]
    assert all(np.isfinite(x["loss"]) and x["lr"] > 0 for x in lines)


def test_resume_starts_where_the_file_left_off(runs):
    seen, second = runs["seen"], runs["second"]
    assert seen["epoch"] == 2 and seen["it"] == 4 and seen["count"] == 4
    payload = seen["payload"]
    assert payload["epoch"] == 2 and payload["optimizer_state"]["count"] == 4
    assert seen["conf"].tobytes() == payload["sampler"]["confidence_groups"].numpy().tobytes()
    assert second["start_epoch"] == 2 and second["start_iter"] == 4
    assert second["iterations"] == 6 and second["state"].optimizer.count == 6
    assert sorted(p.name for p in second["ckpt_dir"].iterdir()) == [
        "checkpoint_epoch_2.pth", "checkpoint_epoch_3.pth"]
    assert load_checkpoint(second["ckpt_dir"] / "checkpoint_epoch_3.pth")["it"] == 6


def test_test_cli_evaluates_a_checkpoint(runs):
    ckpt = runs["second"]["ckpt_dir"] / "checkpoint_epoch_3.pth"
    (res,) = test.main(_args(runs["out"], "--ckpt", str(ckpt), "--infer_time", "--save_to_file"))
    assert len(res["det_annos"]) == 4 and res["infer_batches"] == 2
    assert res["infer_ms_per_frame"] > 0 and res["sec_per_frame"] > 0
    assert sorted(a["frame_id"] for a in res["det_annos"]) == [0, 1, 2, 3]
    for a in res["det_annos"]:
        assert np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
        assert len(a["score"]) <= 128 and set(a["pred_labels"]) <= {1, 2, 3}
    assert res["recalls"]["gt"] > 0 and "recall@0.5" in res["result_str"]
    with open(res["result_pkl"], "rb") as f:
        assert len(pickle.load(f)) == 4


def test_eval_all_polls_the_directory(runs, monkeypatch):
    monkeypatch.setattr(test.time, "sleep", lambda s: None)
    results = test.main(_args(runs["out"], "--eval_all", "--max_waiting_mins", "1"))
    assert [r["ckpt"].rsplit("_", 1)[-1] for r in results] == ["2.pth", "3.pth"]
    ledger = runs["second"]["out_dir"] / "eval" / "eval_list_default.txt"
    assert ledger.read_text().split() == ["2", "3"]
    assert test.main(_args(runs["out"], "--eval_all", "--max_waiting_mins", "1")) == []


def test_demo_runs_over_point_files(runs, tmp_path):
    rng = np.random.RandomState(4)
    for i in range(2):
        scene = make_scene(rng, ["Vehicle", "Pedestrian", "Cyclist"], num_objects=6,
                           num_bg_points=1500, pc_range=(-25.6, -25.6, -2, 25.6, 25.6, 4.0))
        np.save(tmp_path / f"scene_{i}.npy", scene["points"])
    ckpt = runs["second"]["ckpt_dir"] / "checkpoint_epoch_3.pth"
    cfg_args = ["--cfg_file", CFG, "--device", "cpu", "--data_path", str(tmp_path), "--ext",
                ".npy", "--ckpt", str(ckpt)]
    # the demo reads the config as it is: the full-size model over a small scene
    annos = demo.main(cfg_args[:-2])
    assert [a["frame_id"] for a in annos] == [0, 1]
    assert all(np.isfinite(a["boxes_lidar"]).all() for a in annos)
    with pytest.raises(RuntimeError, match="size mismatch"):
        demo.main(cfg_args)  # the shrunk model's checkpoint does not fit it


def test_multi_device_flags_wait(tmp_path):
    for flag in (["--spatial_shard", "2"], ["--model_shard", "2"], ["--multihost"],
                 ["--tcp_port", "1234"]):
        with pytest.raises(NotImplementedError, match="multi-device"):
            train.main(_args(tmp_path, *flag))
    with pytest.raises(NotImplementedError, match="multi-device"):
        test.main(_args(tmp_path, "--multihost", "--ckpt", "x"))


def test_device_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, extra in ((train.main, []), (test.main, ["--ckpt", "x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(_args(tmp_path, *extra, device=()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--cfg_file", CFG, "--data_path", str(tmp_path)])


def test_loader_ends_its_workers_when_left_early():
    """``--infer_time`` stops reading the loader after its batches: the
    PrefetchLoader's worker threads then end instead of blocking on a full
    queue."""
    import threading

    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.utils.config import cfg_from_list, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(CFG)
    cfg_from_list(["DATA_CONFIG.NUM_SCENES", "12", "DATA_CONFIG.NUM_BG_POINTS", "1500"], cfg)
    _, loader = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 1, training=False,
                                 workers=2)
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    workers = [t for t in threading.enumerate() if t not in before]
    assert len(workers) == 2
    it.close()
    for t in workers:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in workers)
    assert len(list(loader)) == 12  # a later pass reads every batch
