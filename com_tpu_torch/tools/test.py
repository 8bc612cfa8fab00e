"""Evaluation CLI of the port (counterpart of ``tools/test.py``: one
checkpoint, or ``--eval_all`` polling a checkpoint directory; and
``--device``).

    python -m com_tpu_torch.tools.test --cfg_file CFG --ckpt FILE [--device cpu]
    python -m com_tpu_torch.tools.test --cfg_file CFG --eval_all [--device cpu]

Outputs go under ``--output_dir`` (default ``output/``) / EXP_GROUP_PATH /
TAG / ``--extra_tag`` / ``eval``: the log, the ``eval_list_{tag}.txt``
ledger of the epochs ``--eval_all`` evaluated, and with ``--save_to_file``
``{checkpoint name}/result.pkl`` (the det_annos).  ``--infer_time`` reports
the device-synced latency a frame over at most 20 batches.  ``main(argv)``
returns each checkpoint's result.  ``--multihost`` evaluates data-parallel,
one process a card, each over its shard of the split (``torchrun
--nproc_per_node N -m com_tpu_torch.tools.test ... --multihost``); every
rank gets the whole split's detections and recall, rank 0 writes the files.
"""
from __future__ import annotations

import argparse
import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..parallel.sharding import gather_objects
from .train import data_mesh, dataset_meta, output_dir, require_dense_head


def parse_config(argv=None):
    from ..utils.config import CfgNode, cfg_from_list, cfg_from_yaml_file

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true",
                        help="poll the checkpoint directory and evaluate checkpoints as they "
                             "appear")
    parser.add_argument("--max_waiting_mins", type=int, default=30)
    parser.add_argument("--ckpt_dir", type=str, default=None,
                        help="the checkpoint directory to poll")
    parser.add_argument("--eval_tag", type=str, default="default")
    parser.add_argument("--start_epoch", type=int, default=0,
                        help="skip checkpoints older than this epoch in --eval_all")
    parser.add_argument("--infer_time", action="store_true",
                        help="report the latency a frame (device-synced)")
    parser.add_argument("--save_to_file", action="store_true",
                        help="write the detections to result.pkl")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel eval over torch.distributed, one process a card "
                             "(torchrun, or SLURM with --tcp_port)")
    parser.add_argument("--tcp_port", type=int, default=None,
                        help="rendezvous port for SLURM launches")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


class EvalContext:
    """What does not depend on the checkpoint, built once (``--eval_all``
    reuses it for each checkpoint): the loader, the model, the eval step."""

    def __init__(self, cfg, args, logger, mesh=None):
        from ..data import build_dataloader
        from ..models.detectors import build_network
        from ..train.eval import make_eval_step
        from ..utils.device import resolve_device

        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(args.device)
        names = list(cfg.CLASS_NAMES)
        batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)  # a rank's
        self.dataset, self.loader = build_dataloader(cfg.DATA_CONFIG, names, batch_size,
                                                     training=False, workers=args.workers,
                                                     logger=logger, dist=mesh is not None)
        self.meta = dataset_meta(cfg, self.dataset)
        self.net = build_network(cfg.MODEL, self.meta, device=self.device)
        self.eval_step = make_eval_step(self.net, cfg.MODEL, names, self.meta,
                                        device=self.device)

    def load(self, ckpt_path):
        from ..utils.checkpoint import load_checkpoint

        payload = load_checkpoint(ckpt_path, map_location=self.device)
        self.net.load_state_dict(payload["model_state"])
        return payload

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def infer_time(ctx: EvalContext, max_batches: int = 20):
    """Median seconds a frame of the eval step over the loader's first
    ``max_batches`` batches, each between two device syncs, after one
    warm-up call on the first batch.  Returns (seconds, batches)."""
    lat = []
    for i, batch in enumerate(ctx.loader):
        if i == max_batches:
            break
        if i == 0:
            ctx.eval_step(batch)
        ctx.sync()
        t0 = time.perf_counter()
        ctx.eval_step(batch)
        ctx.sync()
        lat.append((time.perf_counter() - t0) / batch["points"].shape[0])
    return float(np.median(lat)), len(lat)


def evaluate_ckpt(ckpt_path, cfg, args, logger, ctx: EvalContext, eval_dir: Path):
    """One checkpoint: load, optional latency, ``eval_model`` (over the
    mesh's shards with ``--multihost``), optional ``result.pkl`` (rank 0),
    ``dataset.evaluation`` with the config's EVAL_METRIC."""
    from ..train.eval import eval_model

    ctx.load(ckpt_path)
    out = {"ckpt": str(ckpt_path)}
    if args.infer_time:
        sec, n = infer_time(ctx)
        out.update(infer_ms_per_frame=1e3 * sec, infer_batches=n)
        logger.info("inference latency: %.2f ms/frame (median of %d batches)", 1e3 * sec, n)
    post = cfg.MODEL.get("POST_PROCESSING", {})
    det_annos, recalls, spf = eval_model(
        ctx.eval_step, ctx.loader, list(cfg.CLASS_NAMES), logger=logger,
        recall_thresh_list=tuple(post.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7])),
        mesh=ctx.mesh)
    out.update(det_annos=det_annos, recalls=recalls, sec_per_frame=spf)
    if args.save_to_file and (ctx.mesh is None or ctx.mesh.rank == 0):
        path = eval_dir / Path(ckpt_path).stem / "result.pkl"
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(det_annos, f)
        out["result_pkl"] = path
        logger.info("wrote %s (%d frames)", path, len(det_annos))
    if hasattr(ctx.dataset, "evaluation"):
        out["result_str"], out["result"] = ctx.dataset.evaluation(
            det_annos, list(cfg.CLASS_NAMES), eval_metric=post.get("EVAL_METRIC", None))
        logger.info("eval result: %s", out["result_str"])
    return out


def main(argv=None):
    """Evaluate; returns the list of each checkpoint's result dict (with
    ``--multihost``, the same on every rank)."""
    args, cfg = parse_config(argv)
    require_dense_head(cfg, "test")
    with data_mesh(args) as mesh:
        return _evaluate(args, cfg, mesh)


def _evaluate(args, cfg, mesh):
    from ..utils.checkpoint import _ckpt_files
    from ..utils.common import create_logger

    rank = mesh.rank if mesh is not None else 0
    out_dir = output_dir(args, cfg)
    eval_dir = out_dir / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(eval_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
                           if rank == 0 else None, rank=rank)

    if not args.eval_all:
        if args.ckpt is None:
            raise ValueError("--ckpt is needed unless --eval_all")
        return [evaluate_ckpt(args.ckpt, cfg, args, logger, EvalContext(cfg, args, logger, mesh),
                              eval_dir)]

    # repeat_eval_ckpt: poll the directory, evaluate new checkpoints as they appear
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else out_dir / "ckpt"
    ledger = eval_dir / f"eval_list_{args.eval_tag}.txt"
    evaluated = set(ledger.read_text().split()) if ledger.exists() else set()
    ctx, results, waited = None, [], 0.0
    while waited < args.max_waiting_mins * 60:
        todo = [(e, p) for e, p in _ckpt_files(ckpt_dir)
                if str(e) not in evaluated and e >= args.start_epoch]
        todo = gather_objects(todo, mesh)[0]  # rank 0's list: every rank evaluates the same
        if not todo:
            time.sleep(30)
            waited += 30
            continue
        waited = 0.0
        if ctx is None:
            ctx = EvalContext(cfg, args, logger, mesh)
        for epoch, path in todo:
            logger.info("evaluating checkpoint epoch %d", epoch)
            results.append(evaluate_ckpt(path, cfg, args, logger, ctx, eval_dir))
            evaluated.add(str(epoch))
            if rank == 0:
                with open(ledger, "a") as f:
                    f.write(f"{epoch}\n")
    return results


if __name__ == "__main__":
    main()
