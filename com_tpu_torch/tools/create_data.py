"""Data preparation CLI of the port (counterpart of ``tools/create_data.py``:
the same ``--func`` choices, flags and output files).

    python -m com_tpu_torch.tools.create_data --func FUNC [--cfg_file CFG]
        [--db_info_path PKL] [--root_path DIR] [--out_dir DIR]
        [--num_point_features 5] [--sampled_interval 1]

* ``create_gt_database``: the train split's objects cropped into
  ``gt_database/*.bin`` and ``waymo_dbinfos_train.pkl`` under ``--out_dir``
  (default DATA_CONFIG.DATA_PATH), through the config's dataset
  (``WaymoDataset.create_groundtruth_database``).
* ``annotate_database``: ``occupancy_ratio`` and ``facade_type`` on every
  entry of ``--db_info_path`` (``data/annotator.py``), written beside it as
  ``*_annotated.pkl``; the ``.bin`` files are read under ``--root_path``
  (default the pickle's folder).
* ``integrate_database``: every entry's points packed into one
  ``*_global.npy`` under ``--root_path`` and the entries, each with its
  ``global_data_offset``, into ``*_integrated.pkl``
  (create_integrated_database.py:10-54).
* ``create_waymo_infos``: the tfrecords under ``--root_path`` converted into
  per-sequence infos and ``.npy`` frames (``data/waymo/waymo_utils.py``;
  needs tensorflow and waymo-open-dataset) and ``waymo_infos.pkl``.
* ``create_pandaset_infos``: ``pandaset_infos_{train,val,test}.pkl`` and the
  train GT database from the devkit layout
  (``data/pandaset/pandaset_utils.py``).

A prepared tree then trains through ``com_tpu_torch.tools.train`` with
``DB_INFO_PATH`` naming the annotated (or integrated) pickle.  ``main(argv)``
runs in-process and returns what the function wrote.
"""
from __future__ import annotations

import argparse
import copy
import pickle
from pathlib import Path

import numpy as np


def database_data_config(data_cfg):
    """The dataset config that builds the database: the config's own less
    its ``gt_sampling`` augmentation, which reads the very database being
    written (``com_tpu``'s CLI keeps it, and so raises FileNotFoundError on
    a tree without one)."""
    data_cfg = copy.deepcopy(data_cfg)
    aug = data_cfg.get("DATA_AUGMENTOR")
    if aug is not None:
        aug["AUG_CONFIG_LIST"] = [a for a in aug.get("AUG_CONFIG_LIST", [])
                                  if a.get("NAME") != "gt_sampling"]
    return data_cfg


def create_gt_database(args, cfg):
    from ..data import build_dataloader

    dataset, _ = build_dataloader(database_data_config(cfg.DATA_CONFIG), list(cfg.CLASS_NAMES),
                                  batch_size=1, training=True, workers=1)
    out = Path(args.out_dir or cfg.DATA_CONFIG.DATA_PATH)
    db_infos = dataset.create_groundtruth_database(out, used_classes=cfg.CLASS_NAMES)
    print("classes:", {k: len(v) for k, v in db_infos.items()})
    return db_infos


def annotate_database(args, cfg):
    """Annotate a database pickle with occupancy and facade."""
    from ..data.annotator import annotate_db_infos

    path = Path(args.db_info_path)
    with open(path, "rb") as f:
        db_infos = pickle.load(f)
    annotate_db_infos(db_infos, root_path=args.root_path or path.parent)
    out = path.with_name(path.stem + "_annotated.pkl")
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    print("wrote", out)
    return db_infos


def integrate_database(args, cfg):
    """Pack the entries' ``.bin`` files into one global array and offsets."""
    path = Path(args.db_info_path)
    root = Path(args.root_path or path.parent)
    with open(path, "rb") as f:
        db_infos = pickle.load(f)
    chunks = []
    offset = 0
    nfeat = args.num_point_features
    for infos in db_infos.values():
        for info in infos:
            pts = np.fromfile(str(root / info["path"]), dtype=np.float32).reshape(-1, nfeat)
            info["global_data_offset"] = (offset, offset + len(pts))
            offset += len(pts)
            chunks.append(pts)
    global_arr = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, nfeat))
    np.save(root / (path.stem + "_global.npy"), global_arr)
    with open(path.with_name(path.stem + "_integrated.pkl"), "wb") as f:
        pickle.dump(db_infos, f)
    print("wrote global array", global_arr.shape)
    return db_infos


def create_pandaset_infos(args, cfg):
    """Pandaset infos and the train GT database from the devkit layout
    (pandas and poses.json, no devkit)."""
    from ..data.pandaset.pandaset_utils import create_pandaset_infos as build

    # a model config (DATA_CONFIG nested) or the dataset config itself
    dc = cfg.get("DATA_CONFIG", cfg) if cfg is not None else {}
    root = Path(args.root_path or dc["DATA_PATH"])
    out = Path(args.out_dir or root)
    return build(dc, cfg.get("CLASS_NAMES", []) if cfg is not None else [], root, out)


def create_waymo_infos(args, cfg):
    """Convert the tfrecords under ``--root_path`` (needs tensorflow and
    waymo-open-dataset)."""
    from ..data.waymo.waymo_utils import process_single_sequence

    root = Path(args.root_path)
    out = Path(args.out_dir or root / "waymo_processed_data")
    records = sorted(root.glob("*.tfrecord*"))
    if not records:
        print(f"no tfrecords under {root}")
        return []
    all_infos = []
    for seq in records:
        all_infos.extend(process_single_sequence(seq, out, sampled_interval=args.sampled_interval,
                                                 has_label=True))
    with open(out / "waymo_infos.pkl", "wb") as f:
        pickle.dump(all_infos, f)
    print(f"extracted {len(all_infos)} frames from {len(records)} sequences")
    return all_infos


FUNCS = {f.__name__: f for f in (create_gt_database, annotate_database, integrate_database,
                                 create_waymo_infos, create_pandaset_infos)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--func", required=True, choices=list(FUNCS))
    parser.add_argument("--cfg_file", type=str, default=None)
    parser.add_argument("--db_info_path", type=str, default=None)
    parser.add_argument("--root_path", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    parser.add_argument("--num_point_features", type=int, default=5)
    parser.add_argument("--sampled_interval", type=int, default=1)
    args = parser.parse_args(argv)

    cfg = None
    if args.cfg_file:
        from ..utils.config import CfgNode, cfg_from_yaml_file

        cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    return FUNCS[args.func](args, cfg)


if __name__ == "__main__":
    main()
