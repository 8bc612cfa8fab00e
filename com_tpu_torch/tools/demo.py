"""Inference demo of the port over point-cloud files (counterpart of
``tools/demo.py``; and ``--device``): prints each sample's top detections.

    python -m com_tpu_torch.tools.demo --cfg_file CFG --data_path DIR_OR_FILE \\
        [--ckpt FILE] [--ext .npy] [--save_viz DIR] [--device cpu]

``--save_viz`` writes a bird's-eye-view PNG a sample and needs matplotlib.
``main(argv)`` returns the det_annos, one a sample.
"""
from __future__ import annotations

import argparse
import importlib.util
from pathlib import Path

from .train import dataset_meta


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True,
                        help="a point cloud file or a directory of them")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--ext", type=str, default=".bin", choices=[".bin", ".npy"])
    parser.add_argument("--save_viz", type=str, default=None,
                        help="directory for BEV PNG renders of each sample")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.save_viz and importlib.util.find_spec("matplotlib") is None:
        raise ImportError("--save_viz needs matplotlib, which is not installed here; "
                          "run the demo without --save_viz")

    from ..data.demo_dataset import DemoDataset
    from ..models.detectors import build_network
    from ..train.eval import eval_model, make_eval_step
    from ..utils.checkpoint import load_checkpoint
    from ..utils.common import create_logger
    from ..utils.config import CfgNode, cfg_from_yaml_file
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    logger = create_logger()
    cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    names = list(cfg.CLASS_NAMES)
    dataset = DemoDataset(cfg.DATA_CONFIG, names, root_path=args.data_path, ext=args.ext,
                          logger=logger)
    logger.info("loaded %d samples", len(dataset))
    meta = dataset_meta(cfg, dataset)
    net = build_network(cfg.MODEL, meta, device=dev)
    if args.ckpt:
        net.load_state_dict(load_checkpoint(args.ckpt, map_location=dev)["model_state"])
        logger.info("loaded checkpoint %s", args.ckpt)
    eval_step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    det_annos = []
    for idx in range(len(dataset)):
        batch = dataset.collate_batch([dataset[idx]])
        anno = eval_model(eval_step, [batch], names)[0][0]
        det_annos.append(anno)
        logger.info("sample %d: %d detections (top 20 shown)", idx, len(anno["score"]))
        for name, s, b in zip(anno["name"][:20], anno["score"][:20], anno["boxes_lidar"][:20]):
            logger.info("  %-10s score=%.3f xyz=(%.1f, %.1f, %.1f) lwh=(%.1f, %.1f, %.1f) "
                        "yaw=%.2f", name, s, *b[:7])
        if args.save_viz:
            from ..utils.visualize import draw_scene_bev

            out_dir = Path(args.save_viz)
            out_dir.mkdir(parents=True, exist_ok=True)
            pts = batch["points"][0][batch["points_mask"][0]]
            out_png = out_dir / f"sample_{idx:04d}.png"
            draw_scene_bev(pts, pred_boxes=anno["boxes_lidar"], pred_scores=anno["score"],
                           pred_labels=anno["pred_labels"], class_names=names,
                           point_range=dataset.point_cloud_range, save_path=out_png,
                           title=f"sample {idx}")
            logger.info("  wrote %s", out_png)
    return det_annos


if __name__ == "__main__":
    main()
