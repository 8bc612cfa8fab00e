"""Training CLI of the port (counterpart of ``tools/train.py``: the same
flags, and ``--device``).

    python -m com_tpu_torch.tools.train --cfg_file CFG [--device cpu] [--set KEY VALUE ...]

Outputs go under ``--output_dir`` (default ``output/`` of the checkout) /
EXP_GROUP_PATH / TAG / ``--extra_tag``: ``log_train_*.txt``,
``ckpt/checkpoint_epoch_{N}.pth`` (and the rolling ``ckpt/latest_model.pth``)
and ``metrics/metrics.jsonl``.  A run resumes from ``--ckpt``, else from the
newest readable checkpoint there: at its epoch and iteration, with the
optimizer's moments and count, the curriculum states and the sampler's
confidences.  ``--device`` defaults to ``cuda`` and raises without a card.
``main(argv)`` runs in-process and returns what it did; ``on_start(info)``
sees the state after any resume, before the first step, and
``metric_hook(epoch, it, metrics)`` each step's device metrics.

Data-parallel on N cards of a host, one process a card (NCCL; the global
batch is ``BATCH_SIZE_PER_GPU`` x N, and the one-cycle schedule counts its
steps):

    torchrun --nproc_per_node N -m com_tpu_torch.tools.train --cfg_file CFG --multihost

Under SLURM, ``--multihost --tcp_port PORT`` rendezvous at the first host of
the job.  ``--spatial_shard`` and ``--model_shard`` above 1 raise: the
mesh's spatial and model axes are not ported.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
from pathlib import Path

import torch
import torch.distributed as dist

from ..parallel.mesh import check_axes, init_multihost, make_mesh
from ..parallel.sharding import activate, active_mesh

REPO = Path(__file__).resolve().parents[2]


def parse_config(argv=None):
    from ..utils.config import CfgNode, cfg_from_list, cfg_from_yaml_file

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="parameters only, from this package's or the reference's "
                             "checkpoint; shape mismatches are skipped")
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=50)
    parser.add_argument("--ckpt_save_time_interval", type=int, default=300,
                        help="rolling latest_model save period (seconds)")
    parser.add_argument("--logger_iter_interval", type=int, default=50)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--spatial_shard", type=int, default=1,
                        help="shard the BEV canvas rows over this many cards (not ported: "
                             "above 1 raises)")
    parser.add_argument("--model_shard", type=int, default=1,
                        help="shard conv output channels over this many cards (not ported: "
                             "above 1 raises)")
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel over torch.distributed: one process a card, "
                             "started by torchrun (or SLURM with --tcp_port)")
    parser.add_argument("--tcp_port", type=int, default=None,
                        help="rendezvous port for SLURM launches (the reference's --tcp_port)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    check_axes(args.spatial_shard, args.model_shard)
    cfg = cfg_from_yaml_file(args.cfg_file, CfgNode())
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return args, cfg


@contextlib.contextmanager
def data_mesh(args):
    """With ``--multihost``: the process group (``init_multihost``; kept if
    one is initialised already, else destroyed at the end) and its data
    mesh, active for the block; else None."""
    if not args.multihost:
        yield None
        return
    owned, previous = not dist.is_initialized(), active_mesh()
    init_multihost(args.tcp_port, device=args.device)
    mesh = make_mesh(args.device)
    activate(mesh)
    try:
        yield mesh
    finally:
        activate(previous)
        if owned:
            dist.destroy_process_group()


def output_dir(args, cfg) -> Path:
    root = Path(args.output_dir) if args.output_dir else REPO / "output"
    return root / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag


def dataset_meta(cfg, dataset):
    from ..models.detectors import DatasetMeta

    grid = dataset.grid_size if dataset.grid_size is not None else [468, 468, 1]
    vsize = dataset.voxel_size if dataset.voxel_size is not None else [0.32, 0.32, 6.0]
    return DatasetMeta(list(cfg.CLASS_NAMES), dataset.point_cloud_range, vsize, grid,
                       dataset.point_feature_encoder.num_point_features)


def require_dense_head(cfg, cli: str):
    """Raise for a detector without ``MODEL.DENSE_HEAD`` (PointRCNN): the JAX
    package's train and test CLIs read it (and its train CLI initialises the
    model from ``device_batch_keys``, which give PointRCNN no points), so
    they cannot run one, and neither do these."""
    if cfg.MODEL.get("DENSE_HEAD") is None:
        raise NotImplementedError(
            f"the {cli} CLI for a detector without MODEL.DENSE_HEAD ({cfg.MODEL.NAME}) is not "
            f"ported: com_tpu's tools/{cli}.py cannot run one either; use build_network, "
            "make_train_step / train_model and make_eval_step")


def main(argv=None, on_start=None, metric_hook=None):
    """Train; returns {"state", "iterations", "start_epoch", "start_iter",
    "epochs", "out_dir", "ckpt_dir", "rank", "world", "global_batch"}.
    With ``--multihost`` each rank runs this over its loader shard; only
    rank 0 logs to a file and writes metrics and checkpoints."""
    args, cfg = parse_config(argv)
    require_dense_head(cfg, "train")
    with data_mesh(args) as mesh:
        return _train(args, cfg, mesh, on_start, metric_hook)


def _train(args, cfg, mesh, on_start, metric_hook):

    from ..data import build_dataloader
    from ..data.processor import pipeline_presorts_points
    from ..models.detectors import build_network
    from ..train.loop import train_model
    from ..train.optim import build_optimizer
    from ..train.state import TrainState
    from ..train.step import conf_shape_for, curriculum_kwargs, device_batch_keys, make_train_step
    from ..utils.checkpoint import (load_checkpoint, load_params_only, resume_latest,
                                    sampler_confidences)
    from ..utils.common import create_logger, set_random_seed
    from ..utils.config import log_config_to_file
    from ..utils.device import resolve_device
    from ..utils.metrics import MetricsLogger

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    out_dir = output_dir(args, cfg)
    ckpt_dir = out_dir / "ckpt"
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt"
                           if rank == 0 else None, rank=rank)
    logger.info("device: %s, rank %d of %d (%s)", dev, rank, world,
                mesh.backend if mesh is not None else "one process")
    log_config_to_file(cfg, logger=logger)
    if args.fix_random_seed:
        set_random_seed(args.seed)

    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)  # a rank's
    global_batch = batch_size * world
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)
    names = list(cfg.CLASS_NAMES)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, names, batch_size, training=True,
                                       workers=args.workers, logger=logger, seed=args.seed,
                                       dist=mesh is not None)
    meta = dataset_meta(cfg, dataset)
    if ("VFE" in cfg.MODEL and "ASSUME_SORTED_POINTS" not in cfg.MODEL.VFE
            and pipeline_presorts_points(cfg.DATA_CONFIG, meta.voxel_size)):
        # the pipeline sorts points by pillar, so the VFE drops its device sort
        cfg.MODEL.VFE["ASSUME_SORTED_POINTS"] = True
    net = build_network(cfg.MODEL, meta, device=dev, seed=args.seed)
    logger.info("model %s: %.2fM params", cfg.MODEL.NAME,
                sum(p.numel() for p in net.parameters()) / 1e6)

    steps_per_epoch = len(loader)  # of the global batch: every rank takes each step
    opt, lr_fn = build_optimizer(net, cfg.OPTIMIZATION, total_steps=steps_per_epoch * epochs,
                                 steps_per_epoch=steps_per_epoch)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names), device=dev,
                              **curriculum_kwargs(cfg.MODEL, names))
    if args.pretrained_model:
        load_params_only(args.pretrained_model, net, logger=logger)
    if args.ckpt:  # an explicit checkpoint comes before the newest one
        resumed = load_checkpoint(args.ckpt, state)
        logger.info("resumed from --ckpt %s", args.ckpt)
    else:
        resumed = resume_latest(ckpt_dir, state, logger=logger)
    start_epoch = start_iter = 0
    if resumed is not None:
        start_epoch, start_iter = int(resumed["epoch"]), int(resumed["it"])
        conf = sampler_confidences(resumed)
        if conf is not None:
            dataset.set_confidence_groups(conf)

    step = make_train_step(net, cfg.MODEL, names, meta, opt, (int(meta.grid_size[1]),
                                                              int(meta.grid_size[0])), device=dev,
                           seed=args.seed)
    mlog = MetricsLogger(out_dir / "metrics") if rank == 0 else None
    log_every = args.logger_iter_interval

    def hook(epoch, it, metrics):
        if mlog is not None and it % log_every == 0:
            keys = [k for k, v in metrics.items() if v.dim() == 0]
            values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
            scalars = dict(zip(keys, values))
            step_idx = epoch * steps_per_epoch + it
            scalars["lr"] = lr_fn(step_idx)
            mlog.log(step_idx, scalars)
        if metric_hook is not None:
            metric_hook(epoch, it, metrics)

    if on_start is not None:
        on_start({"state": state, "dataset": dataset, "loader": loader, "payload": resumed,
                  "start_epoch": start_epoch, "start_iter": start_iter, "ckpt_dir": ckpt_dir})
    logger.info("start training: epochs %d..%d x %d steps, global batch %d (%d a rank x %d)",
                start_epoch, epochs - 1, steps_per_epoch, global_batch, batch_size, world)
    state, iterations = train_model(
        step, state, loader, epochs, ckpt_dir=ckpt_dir, logger=logger, start_epoch=start_epoch,
        ckpt_save_interval=args.ckpt_save_interval,
        ckpt_save_time_interval=float(args.ckpt_save_time_interval),
        max_ckpt_save_num=args.max_ckpt_save_num, log_interval=log_every, metric_hook=hook,
        device=dev, batch_keys=device_batch_keys(cfg.MODEL), start_iter=start_iter)
    if mlog is not None:
        mlog.close()
    logger.info("training done: %d iterations", iterations)
    return {"state": state, "iterations": iterations, "start_epoch": start_epoch,
            "start_iter": start_iter, "epochs": epochs, "out_dir": out_dir, "ckpt_dir": ckpt_dir,
            "rank": rank, "world": world, "global_batch": global_batch}


if __name__ == "__main__":
    main()
