"""How far the flagship's COM feedback moves the COM2 draw against the
length of its training, on Waymo trees the port prepares.

    python -m com_tpu_torch.tools.perf.rehearsal_scale [--frames 20 120] [--epochs 5]
        [--points 163840] [--device cuda] [--out DIR]

For each count of frames a train sequence: a tree of
``dataset_trees.write_waymo_tree`` (2 train sequences, SAMPLED_INTERVAL 5
keeps a fifth: frames / 5 steps an epoch at batch 2), its database through
``create_data`` (created, annotated), then the flagship's YAML (DATA_PATH
and DB_INFO_PATH set) through the train CLI for ``--epochs`` epochs as the
rehearsal drives it (``com_rehearsal.train_argv``), and each fed epoch's
row of the rehearsal's table: the confidences' mean and, a class, the L1
of the group draw from the size prior (the rehearsal's bar is 0.05 at the
last fed epoch).  Prints one JSON line a tree.  Run it from the repo's root
(the flagship YAML's ``_BASE_CONFIG_`` is relative).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

FLAGSHIP = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"


def _yaml(path, cfg, tree, db_info=None):
    """The flagship's keys with DATA_PATH (and DB_INFO_PATH) set."""
    import yaml

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    data = plain(cfg.DATA_CONFIG)
    data["DATA_PATH"] = str(tree)
    if db_info is not None:
        for aug in data["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]:
            if aug["NAME"] == "gt_sampling":
                aug["DB_INFO_PATH"] = [db_info]
    path.write_text(yaml.safe_dump({"CLASS_NAMES": list(cfg.CLASS_NAMES), "DATA_CONFIG": data,
                                    "MODEL": plain(cfg.MODEL),
                                    "OPTIMIZATION": plain(cfg.OPTIMIZATION)}))
    return path


def scale_run(root, frames, epochs, points, device):
    """One tree and one training run; returns its JSON record."""
    from com_tpu_torch.tools import com_rehearsal, create_data, train
    from com_tpu_torch.tools.dataset_trees import write_waymo_tree
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(FLAGSHIP)
    tree = root / "tree"
    t0 = time.perf_counter()
    write_waymo_tree(tree, seed=24, num_train=frames, num_val=1, num_points=points)
    create_data.main(["--func", "create_gt_database", "--cfg_file",
                      str(_yaml(root / "prep.yaml", cfg, tree))])
    create_data.main(["--func", "annotate_database", "--db_info_path",
                      str(tree / "waymo_dbinfos_train.pkl")])
    prepared = time.perf_counter() - t0
    yaml_path = _yaml(root / "train.yaml", cfg, tree, "waymo_dbinfos_train_annotated.pkl")
    t0 = time.perf_counter()
    out = train.main(com_rehearsal.train_argv(yaml_path, epochs, root / "out", device))
    trained = time.perf_counter() - t0
    rcfg = cfg_from_yaml_file(str(yaml_path))
    names = list(rcfg.CLASS_NAMES)
    sampler = com_rehearsal.sampler_for(rcfg)
    rows = []
    for ep, path in com_rehearsal.epoch_checkpoints(root / "out").items():
        conf = com_rehearsal.checkpoint_confidences(path)
        sampler.epoch, sampler.confidence_groups = ep, conf
        dist = com_rehearsal.distribution_report(sampler, names)
        rows.append({"epoch": ep, "conf_mean": round(float(conf.mean()), 4),
                     "l1": {c: round(d["l1_from_size_prior"], 4) for c, d in dist.items()}})
    return {"frames": frames, "epochs": epochs, "steps": out["iterations"],
            "prepare_s": round(prepared, 1), "train_s": round(trained, 1), "rows": rows}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, nargs="+", default=[20, 120])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--points", type=int, default=163840)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None, help="work directory (default: a temporary one)")
    args = parser.parse_args(argv)
    import logging

    logging.getLogger("com_tpu_torch.r0").addHandler(logging.NullHandler())
    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    records = []
    for frames in args.frames:
        root = Path(args.out) / f"frames_{frames}" if args.out else Path(tempfile.mkdtemp())
        root.mkdir(parents=True, exist_ok=True)
        try:
            record = {**scale_run(root, frames, args.epochs, args.points, args.device),
                      "card": smi}
        finally:
            shutil.rmtree(root, ignore_errors=True)
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    main()
