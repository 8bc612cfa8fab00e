"""The ranks' side of ``tests/test_torch_port_parallel*.py``: functions that
``com_tpu_torch.parallel.launch.run_ranks`` runs in spawned processes.

Spawn imports this module afresh in each child, so it imports torch and the
port only, never JAX.  Each function reads a spec that the test wrote
(``torch.save``), runs its cases on the rank's shard in the gloo group, and
writes the rank's results to ``{out}/rank{r}_{case}.npz``.
"""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from com_tpu_torch.losses import anchor_losses, curriculum
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.parallel.mesh import make_mesh, shard_batch
from com_tpu_torch.parallel.sharding import activate, all_reduce_, reduce_gradients
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.config import cfg_from_yaml_file

TOTAL_STEPS = 100
FLAGSHIP = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"


def tiny_cfg():
    """The flagship config (port's loader) with a narrow one-block backbone,
    16 object slots and f32, for loop and rule tests at a 32x32 grid."""
    cfg = cfg_from_yaml_file(FLAGSHIP)
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.VFE.NUM_FILTERS = [16, 16]
    m.BACKBONE_2D.update(LAYER_NUMS=[1], LAYER_STRIDES=[1], NUM_FILTERS=[16],
                         UPSAMPLE_STRIDES=[1], NUM_UPSAMPLE_FILTERS=[16])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 16
    return cfg


def tiny_batch(rng, b=2, n=1024, m=16):
    """A scene batch for ``tiny_cfg`` (range +-5.12 m): points, 6 boxes a
    scene in 16 slots, the COM side arrays."""
    pts = np.concatenate([rng.uniform(-5, 5, (b, n, 2)), rng.uniform(-1.5, 3.5, (b, n, 1)),
                          rng.rand(b, n, 2)], -1).astype(np.float32)
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-4, 4, (b, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 3.0, (b, 6, 3))
    gt[:, :6, 6] = rng.uniform(-np.pi, np.pi, (b, 6))
    gt[:, :6, 7] = rng.randint(1, 4, (b, 6))
    return {"points": pts, "points_mask": np.ones((b, n), bool), "gt_boxes": gt,
            "num_points_in_gt": (gt[..., 7] > 0).astype(np.float32) * 10,
            "true_object": (gt[..., 7] > 0).astype(np.float32),
            "occupancy_ratio": rng.rand(b, m).astype(np.float32),
            "facade_type": rng.randint(0, 4, (b, m)).astype(np.float32)}


def _save(path, **groups):
    """One npz of ``group/key`` arrays (a group is a dict or an array)."""
    flat = {}
    for g, v in groups.items():
        if isinstance(v, dict):
            flat.update({f"{g}/{k}": np.asarray(x) for k, x in v.items()})
        else:
            flat[g] = np.asarray(v)
    np.savez(path, **flat)


def _numpy(t):
    return t.detach().cpu().numpy().copy()


def _build(case):
    """A case's net (its start weights loaded), a fresh state with the
    case's curriculum start, and its train step, on the case's device (the
    CPU by default); the state is replicated over the active mesh, if any."""
    cfg, meta, names = case["cfg"], case["meta"], list(case["cfg"].CLASS_NAMES)
    dev = case.get("device", "cpu")
    net = build_network(cfg.MODEL, meta, device=dev)
    net.load_state_dict(case["start"])
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, TOTAL_STEPS, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device=dev, **curriculum_kwargs(cfg.MODEL, names))
    kind, fields = case["curriculum"]
    cls = {"CurriculumState": curriculum.CurriculumState,
           "AnchorCurriculumState": anchor_losses.AnchorCurriculumState}[kind]
    state.curriculum = (cls(*(torch.as_tensor(f, device=dev) for f in fields)),)
    step = make_train_step(net, cfg.MODEL, names, meta, opt, case["fmap_hw"], device=dev)
    return net, state, step


def launch_counts():
    """The kernels' launch counters of this process."""
    from com_tpu_torch.ops import conv2d, seg_scan, stamp

    return {"k1": seg_scan.launches, "k1_bwd": seg_scan.bwd_launches, "k2": conv2d.launches,
            "k2_dgrad": conv2d.dgrad_launches, "k2w": conv2d.wgrad_launches,
            "k3": stamp.gauss_launches + stamp.last_wins_launches}


def tiny_case(device="cpu", bias_shift=0.0):
    """``tiny_cfg`` from seeded weights (every norm's bias moved by
    ``bias_shift``) on 2 scenes of ``tiny_batch``, as a step case."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.models.layers import BatchNorm

    cfg = tiny_cfg()
    meta = DatasetMeta(list(cfg.CLASS_NAMES), (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0),
                       (0.32, 0.32, 6.0), (32, 32, 1), 5)
    net = build_network(cfg.MODEL, meta, device="cpu", seed=1)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                mod.bias.add_(bias_shift)
    zero = (np.float32(0), np.float32(0), np.float32(0), np.bool_(False))
    return dict(cfg=cfg, meta=meta, start=net.state_dict(), curriculum=("CurriculumState", zero),
                fmap_hw=(32, 32), epoch=0, device=device,
                batch=tiny_batch(np.random.RandomState(5)),
                batches=[tiny_batch(np.random.RandomState(i)) for i in range(2)])


def run_step(case, batch):
    """``loss_fn`` + backward, the gradients before and after
    ``reduce_gradients``, then a whole step from the same start and the
    epoch-end reduction of the confidence accumulators (as
    ``train_model``'s)."""
    net, state, step = _build(case)
    start = copy.deepcopy(net.state_dict())
    epoch = case["epoch"]
    before = launch_counts()
    loss, new_cur, _, tb = step.loss_fn(state, batch, epoch)
    loss.backward()
    local = {k: _numpy(p.grad) for k, p in net.named_parameters()}
    reduce_gradients(net.parameters())
    grads = {k: _numpy(p.grad) for k, p in net.named_parameters()}
    stats = {k: _numpy(v) for k, v in net.state_dict().items() if "running" in k}
    net.load_state_dict(start)
    net.zero_grad(set_to_none=True)
    state, metrics = step(state, batch, epoch)
    all_reduce_(state.conf_sum, state.conf_cnt)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return dict(loss=_numpy(loss), launches=launches, metrics_loss=_numpy(metrics["loss"]),
                tb={k: _numpy(v) for k, v in tb.items()}, local=local, grads=grads,
                stats=stats, cur={f: _numpy(v) for f, v in new_cur[0]._asdict().items()},
                conf_sum=_numpy(state.conf_sum), conf_cnt=_numpy(state.conf_cnt),
                params={k: _numpy(p) for k, p in net.named_parameters()})


def card_worker(mesh, spec_path, out):
    """The spec's one case on this rank's rows of its batch (the card test;
    TF32 off, as the test's own process has it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = torch.load(spec_path, weights_only=False)
    _save(Path(out) / f"rank{mesh.rank}.npz", **run_step(case, shard_batch(case["batch"], mesh)))


def steps_worker(mesh, spec_path, out):
    """Every case of the spec on this rank's rows of its batch over the
    2-rank mesh; then rank r alone runs case r's whole batch without a mesh
    and over a one-rank group, whose results must be bitwise the same."""
    spec = torch.load(spec_path, weights_only=False)
    for name, case in spec.items():
        _save(Path(out) / f"rank{mesh.rank}_{name}.npz",
              **run_step(case, shard_batch(case["batch"], mesh)))
    solo = [dist.new_group([r]) for r in range(mesh.world)]  # every rank makes every group
    names = sorted(spec)
    if mesh.rank < len(names):
        case = spec[names[mesh.rank]]
        activate(None)
        plain = run_step(case, case["batch"])
        activate(make_mesh("cpu", group=solo[mesh.rank]))
        grouped = run_step(case, case["batch"])
        activate(mesh)
        same = {}
        for key, want in plain.items():
            got = grouped[key]
            pairs = want.items() if isinstance(want, dict) else [("", want)]
            for k, v in pairs:
                g = got[k] if isinstance(got, dict) else got
                same[f"{key}/{k}"] = np.array_equal(g, v)
        _save(Path(out) / f"world1_{names[mesh.rank]}.npz", same=same)


class ShardLoader:
    """``train_model``'s duck-typed loader over fixed global batches: each
    yields the rank's rows (``shard_batch``); the sampler's feedback is
    recorded."""

    def __init__(self, batches, mesh=None):
        self.batches, self.mesh = batches, mesh
        self.dataset = self
        self.received = []

    def set_epoch(self, epoch):
        pass

    def set_confidence_groups(self, conf):
        self.received.append(np.array(conf))

    def __iter__(self):
        for b in self.batches:
            yield b if self.mesh is None else shard_batch(b, self.mesh)


def train_loop(case, mesh, ckpt_dir, epochs=2):
    """``train_model`` over the case's global batches for ``epochs``
    mini-epochs, a checkpoint an epoch; the feedback each epoch, the
    losses and the final state."""
    from com_tpu_torch.train.loop import train_model

    net, state, step = _build(case)
    loader = ShardLoader(case["batches"], mesh)
    losses = []
    state, _ = train_model(step, state, loader, epochs, ckpt_dir=ckpt_dir, device="cpu",
                           metric_hook=lambda e, it, m: losses.append(_numpy(m["loss"])))
    return dict(received=np.stack(loader.received), losses=np.stack(losses),
                conf_sum=_numpy(state.conf_sum), conf_cnt=_numpy(state.conf_cnt),
                params={k: _numpy(p) for k, p in net.named_parameters()})


def evaluate(case, mesh=None):
    """The case's eval over its loader (this rank's shard with a mesh):
    (det_annos, recall counts)."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.train.eval import eval_model, make_eval_step

    cfg, meta, names = case["cfg"], case["meta"], list(case["cfg"].CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device="cpu")
    net.load_state_dict(case["start"])
    net.eval()
    _, loader = build_dataloader(cfg.DATA_CONFIG, names, case["batch_size"], training=False,
                                 workers=1, dist=mesh is not None)
    annos, recalls, _ = eval_model(make_eval_step(net, cfg.MODEL, names, meta, device="cpu"),
                                   loader, names, mesh=mesh)
    return annos, recalls


def shard_orders(ds_cfg, names, epochs=(0, 1)):
    """``build_dataloader(dist=True)``'s (rank, world), its shard order at
    each epoch and the frames it yields at the first."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.utils.config import CfgNode

    _, loader = build_dataloader(CfgNode(ds_cfg), names, 1, dist=True, training=True, seed=4,
                                 workers=1)
    orders = {}
    for e in epochs:
        loader.set_epoch(e)
        orders[f"epoch{e}"] = loader._shard_order()
    loader.set_epoch(epochs[0])
    frames = [str(f) for batch in loader for f in batch["frame_id"]]
    return dict(index=loader.process_index, count=loader.process_count, frames=np.array(frames),
                **orders)


def cli_runs(head, sets, out):
    """The train CLI (``head`` flags, ``--set`` ``sets``) for 1 epoch, then
    the test CLI on its checkpoint with ``--save_to_file``; under a process
    group each with ``--multihost``.  Returns both results."""
    from com_tpu_torch.tools import test, train

    flags = [*head, "--output_dir", str(out)] + (["--multihost"] if dist.is_initialized() else [])
    run = train.main([*flags, "--epochs", "1", "--seed", "3", "--set", *sets])
    ckpt = run["ckpt_dir"] / "checkpoint_epoch_1.pth"
    res = test.main([*flags, "--ckpt", str(ckpt), "--save_to_file", "--set", *sets])[0]
    return run, res


def loop_worker(mesh, spec_path, out):
    """The loop file's cases: the anchor step (``run_step``), ``train_model``
    over 2 mini-epochs, the data-parallel eval, the sharded loader and the
    train and test CLIs with ``--multihost``."""
    import pickle

    spec = torch.load(spec_path, weights_only=False)
    out = Path(out)
    r = mesh.rank
    _save(out / f"rank{r}_anchor.npz", **run_step(spec["anchor"], shard_batch(
        spec["anchor"]["batch"], mesh)))
    _save(out / f"rank{r}_loop.npz", **train_loop(spec["loop"], mesh, out / f"ckpt{r}"))
    with open(out / f"rank{r}_eval.pkl", "wb") as f:
        pickle.dump(evaluate(spec["eval"], mesh), f)
    _save(out / f"rank{r}_shards.npz", **shard_orders(spec["shards"], ["Vehicle"]))
    run, res = cli_runs(*spec["cli"], out / "cli")
    _save(out / f"rank{r}_cli.npz", rank=run["rank"], world=run["world"],
          global_batch=run["global_batch"], iterations=run["iterations"],
          params={k: _numpy(p) for k, p in run["state"].net.named_parameters()})
    with open(out / f"rank{r}_cli.pkl", "wb") as f:
        pickle.dump((res["det_annos"], res["recalls"]), f)


def failing_rank(mesh):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
