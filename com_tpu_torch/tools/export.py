"""Export a model to a self-contained serving artifact (counterpart of
``tools/export.py``; and ``--device``).

    python -m com_tpu_torch.tools.export --cfg_file CFG [--ckpt FILE] \\
        [--output output/export/model] [--batch_size 1] [--max_points N] \\
        [--device cpu] [--set KEY VALUE ...]

The artifact (``.pt2`` + ``.json`` manifest) holds the eval step and its
weights and runs with torch and the port's registered ops alone: load it
with ``com_tpu_torch.utils.serving.load_artifact``, serve it with
``com_tpu_torch.tools.serve``.  ``--ckpt`` takes a port checkpoint or a
reference ``.pth`` (``load_params_only``); without it the weights are the
seeded random init.  The program takes points and points_mask at
``--batch_size`` x ``--max_points`` (default the config's
MAX_POINTS_PER_SCENE): a voxel model raises.  ``main(argv)`` returns
(stem, manifest).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def export_meta(cfg):
    """The model's ``DatasetMeta`` from the config alone, as the JAX CLI
    reads it: the range, the voxelizer's voxel size (0.32 x 0.32 x 6 by
    default), the grid they give and the used point features."""
    from ..models.detectors import DatasetMeta

    dc = cfg.DATA_CONFIG
    pc_range = [float(v) for v in dc.POINT_CLOUD_RANGE]
    proc = {d["NAME"]: d for d in dc.get("DATA_PROCESSOR", [])}
    vsize = [float(v) for v in proc.get(
        "transform_points_to_voxels", {}).get("VOXEL_SIZE", [0.32, 0.32, 6.0])]
    grid = [int(round((pc_range[3 + i] - pc_range[i]) / vsize[i])) for i in range(3)]
    num_feats = len(dc.get("POINT_FEATURE_ENCODING", {}).get(
        "used_feature_list", ["x", "y", "z", "intensity", "elongation"]))
    return DatasetMeta(list(cfg.CLASS_NAMES), pc_range, vsize, grid, num_feats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="checkpoint file (omit: the seeded random init)")
    parser.add_argument("--output", type=str, default="output/export/model",
                        help="artifact stem: writes <stem>.pt2 and <stem>.json")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--max_points", type=int, default=None,
                        help="override DATA_CONFIG.MAX_POINTS_PER_SCENE")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import torch

    from ..models.detectors import build_network
    from ..utils.checkpoint import load_params_only
    from ..utils.config import CfgNode, cfg_from_list, cfg_from_yaml_file
    from ..utils.device import resolve_device
    from ..utils.serving import export_eval_step, make_manifest, write_artifact

    dev = resolve_device(args.device)
    cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    meta = export_meta(cfg)
    net = build_network(cfg.MODEL, meta, device=dev)
    if args.ckpt:
        load_params_only(args.ckpt, net)

    n = args.max_points or int(cfg.DATA_CONFIG.get("MAX_POINTS_PER_SCENE", 180224))
    b = args.batch_size
    batch_spec = {"points": ((b, n, meta.num_point_features), torch.float32),
                  "points_mask": ((b, n), torch.bool)}
    t0 = time.perf_counter()
    program = export_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, batch_spec,
                               device=dev)
    manifest = make_manifest(cfg, meta, batch_spec, [dev.type])
    stem = Path(args.output)
    write_artifact(stem, program, manifest)
    size = stem.with_suffix(".pt2").stat().st_size
    print(f"exported {cfg.MODEL['NAME']} -> {stem}.pt2 ({size / 1e6:.1f} MB, "
          f"device {dev.type}, {time.perf_counter() - t0:.1f} s)")
    return stem, manifest


if __name__ == "__main__":
    main()
