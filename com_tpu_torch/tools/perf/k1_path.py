"""K1 on its path, on the card.

``parity``: the f32 train step of ``tests/test_torch_port_gpu.py::
test_train_step_matches_cpu`` (a 32x32 grid, 2 x 2048 points, the norms'
biases as built) on the card against the CPU, with K1's forward and its
backward each routed through the kernel or through the plain version on the
card, or through the kernel with each forward sum then scaled by 1 - 2^-23,
1 or 1 + 2^-23 at random, about one unit in the last place (``noise<seed>``:
how far rounding alone moves the comparison).  TF32 is off, as in the test.  For each route
and repeat it prints the worst of the test's checks over their tolerances
(a ratio above 1 fails the test) and, where a kernel runs, every K1 call
against its plain version on the same inputs (max: the rows that differ;
sums and the max backward: the largest difference over ``1e-5 * run
sum|x| + 1e-6``; all: the rows whose value differs from the row before in
the same run).

``vfe``: the flagship VFE in one full-width eval step (batch 2, 163,840
Waymo-like points a scene, 468x468): the host's time from the VFE's start
to its return (it queues the work and does not wait for the card), the
card's time between the same two points (CUDA events), and the host time
spent inside the K1 wrappers, means over the steps.

    python -m com_tpu_torch.tools.perf.k1_path [parity] [vfe] [--repeat N] [--shift]
        [--routes kernel,plain,noise0,...] [--deterministic]

Run it from a checkout's root (it reads the configs and ``chip_smoke.py``'s
scene generator there).  ``--shift`` moves every norm's bias up by 3 first;
``--deterministic`` runs the library's deterministic algorithms and warns
at each op that has none.  Each card step prints a hash of its loss,
gradients and statistics: equal hashes, a bit-identical step.
The script also runs against an older checkout of the port: the routes
patch only ``seg_scan._k1`` and, where it exists, ``run_bcast_max_bwd``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

from com_tpu_torch.ops import seg_scan

ROUTES = {"kernel": (False, False), "plain_fwd": (True, False), "plain_bwd": (False, True),
          "plain": (True, True)}  # route -> (plain forward, plain backward)


def _split_rows(out, seg):
    """Rows whose value differs from the row before in the same run."""
    same = seg[:, 1:] == seg[:, :-1]
    return float(((out[:, 1:] != out[:, :-1]).any(-1) & same).sum())


class K1Router:
    """Routes K1's forward and backward calls to the kernel or the plain
    version, and checks each kernel call against the plain version."""

    def __init__(self, plain_fwd: bool, plain_bwd: bool, noise_seed=None):
        self.plain_fwd, self.plain_bwd = plain_fwd, plain_bwd
        self.gen = None
        if noise_seed is not None:
            self.gen = torch.Generator(device="cuda").manual_seed(noise_seed)
        self.worst = {}  # what -> (worst ratio or differing rows, calls)
        self._k1 = seg_scan._k1
        self._bwd = getattr(seg_scan, "run_bcast_max_bwd", None)

    def _note(self, what, value):
        v, n = self.worst.get(what, (0.0, 0))
        self.worst[what] = (max(v, value), n + 1)

    def k1(self, vals, seg, op, counter):
        fwd = counter == "launches"
        if vals.is_cuda and (self.plain_fwd if fwd else self.plain_bwd):
            return seg_scan.run_bcast_plain(vals, seg, op)
        out = self._k1(vals, seg, op, counter)
        if vals.is_cuda:
            want = seg_scan.run_bcast_plain(vals, seg, op)
            what = f"{'fwd' if fwd else 'bwd'} {op} {tuple(vals.shape)} {vals.dtype}"
            self._note(what + " rows split from their run", _split_rows(out, seg))
            if op == "max":
                self._note(what + " rows differing", float((out != want).any(-1).sum()))
            else:
                scale = seg_scan.run_bcast_plain(vals.float().abs(), seg, "sum")
                err = (out.float() - want.float()).abs() / (1e-5 * scale + 1e-6)
                self._note(what + " err/tol", float(err.max()))
            if self.gen is not None and fwd and op == "sum":
                ulps = torch.randint(-1, 2, out.shape, device=out.device, generator=self.gen)
                out = out * (1 + ulps.float() * 2.0 ** -23)
        return out

    def max_bwd(self, g, vals, out, seg):
        if g.is_cuda and self.plain_bwd:
            return seg_scan.run_bcast_max_bwd_plain(g, vals, out, seg)
        got = self._bwd(g, vals, out, seg)
        if g.is_cuda:
            want = seg_scan.run_bcast_max_bwd_plain(g, vals, out, seg)
            scale = seg_scan.run_bcast_plain(g.float().abs(), seg, "sum")
            err = (got.float() - want.float()).abs() / (1e-5 * scale + 1e-6)
            what = f"bwd max fused {tuple(g.shape)} {g.dtype}"
            self._note(what + " err/tol", float(err.max()))
        return got

    def __enter__(self):
        seg_scan._k1 = self.k1
        if self._bwd is not None:
            seg_scan.run_bcast_max_bwd = self.max_bwd
        return self

    def __exit__(self, *exc):
        seg_scan._k1 = self._k1
        if self._bwd is not None:
            seg_scan.run_bcast_max_bwd = self._bwd


def _step_batch():
    """The test's batch: 2 x 2048 points on a 32x32 grid, 6 boxes a sample."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (2, 2048, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-1.5, 3.5, (2, 2048))
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :6, 0:2] = rng.uniform(-4, 4, (2, 6, 2))
    gt[:, :6, 3:6] = rng.uniform(1.0, 3.0, (2, 6, 3))
    gt[:, :6, 7] = rng.randint(1, 4, (2, 6))
    return {"points": pts, "points_mask": np.ones((2, 2048), bool), "gt_boxes": gt,
            "true_object": (gt[..., 7] > 0).astype(np.float32),
            "occupancy_ratio": rng.rand(2, 16).astype(np.float32),
            "facade_type": rng.randint(0, 4, (2, 16)).astype(np.float32)}


def step_grads(device, shift: bool):
    """Loss, gradients and batch statistics of one f32 train step from the
    test's weights (seed 3) on ``device``."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.models.layers import BatchNorm
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.state import TrainState
    from com_tpu_torch.train.step import conf_shape_for, make_train_step
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file("configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = True
    names = list(cfg.CLASS_NAMES)
    meta = DatasetMeta(names, (-5.12, -5.12, -2.0, 5.12, 5.12, 4.0), (0.32, 0.32, 6.0),
                       (32, 32, 1), 5)
    net = build_network(cfg.MODEL, meta, device=device, seed=3)
    if shift:
        with torch.no_grad():
            for mod in net.modules():
                if isinstance(mod, BatchNorm):
                    mod.bias.add_(3.0)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, 1, conf_shape_for(cfg.MODEL, names), device=device)
    step = make_train_step(net, cfg.MODEL, names, meta, opt, (32, 32), device=device)
    running = {k: v for k, v in net.state_dict().items() if "running" in k}
    for v in running.values():
        v.zero_()
    loss, _, _, _ = step.loss_fn(state, _step_batch(), 0)
    loss.backward()
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    stats = {k: v.cpu() / (1 - BatchNorm.MOMENTUM) for k, v in running.items()}
    return float(loss.detach()), grads, stats


def ratios(card, cpu):
    """The test's checks as ratios to their tolerances: loss, each gradient,
    each batch statistic (a ratio above 1 fails the test)."""
    (l0, g0, s0), (l1, g1, s1) = card, cpu
    out = {"loss": abs(l0 - l1) / (1e-4 * abs(l1))}
    gmax = max(float(g.abs().max()) for g in g1.values())
    for k in g1:
        tol = 1e-3 * float(g1[k].abs().max()) + 1e-5 * gmax
        out[k] = float((g0[k] - g1[k]).abs().max()) / tol
    for k in s1:
        if k.endswith("running_mean"):
            norm = k.rsplit(".", 1)[0]
            mean, var = s1[k], s1[f"{norm}.running_var"]
            second = (var + mean * mean).clamp_min(1e-12)
            out[k] = float(((s0[k] - mean).abs() / second.sqrt()).max()) / 1e-5
            out[f"{norm}.running_var"] = float(((s0[f"{norm}.running_var"] - var).abs()
                                                / second).max()) / 1e-5
    return out


def _fingerprint(step) -> str:
    """A hash of a step's loss, gradients and statistics: equal hashes, a
    bit-identical step."""
    import hashlib

    loss, grads, stats = step
    h = hashlib.sha1(np.float64(loss).tobytes())
    for t in (*grads.values(), *stats.values()):
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:10]


def parity(dev, repeat: int, shift: bool, routes, deterministic=False):
    import warnings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:  # library ops in their deterministic versions; the others named
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")
    cpu = step_grads("cpu", shift)
    for route in routes:
        noise = int(route[5:]) if route.startswith("noise") else None
        pf, pb = ROUTES["kernel" if noise is not None else route]
        for rep in range(repeat if noise is None else 1):
            with K1Router(pf, pb, noise) as router:
                card = step_grads(dev, shift)
            torch.cuda.synchronize()
            r = ratios(card, cpu)
            worst = sorted(r.items(), key=lambda kv: -kv[1])[:3]
            verdict = "passes" if worst[0][1] <= 1 else "FAILS"
            print(f"parity shift={int(shift)} route={route} run {rep}: {verdict}; card step "
                  f"{_fingerprint(card)}; worst "
                  + ", ".join(f"{k} {v:.3f}" for k, v in worst), flush=True)
            for what, (v, n) in sorted(router.worst.items()):
                print(f"    K1 {what}: worst {v:.3g} over {n} calls", flush=True)


def vfe_times(dev, iters: int = 20):
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta = chip_smoke.load_config()
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    pts = chip_smoke.waymo_like_points(np.random.RandomState(6), 2, chip_smoke.POINTS,
                                       meta.point_cloud_range)
    batch = {"points": pts, "points_mask": np.ones(pts.shape[:2], bool)}
    marks, k1_host = [], [0.0, 0]
    k1 = seg_scan._k1

    def timed_k1(*args):
        t0 = time.perf_counter()
        out = k1(*args)
        k1_host[0] += time.perf_counter() - t0
        k1_host[1] += 1
        return out

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((time.perf_counter(), ev))

    hooks = [net.vfe.register_forward_pre_hook(mark), net.vfe.register_forward_hook(mark)]
    seg_scan._k1 = timed_k1
    try:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        host = card = 0.0
        k1_host[:] = [0.0, 0]
        for _ in range(iters):
            marks.clear()
            step(batch)
            torch.cuda.synchronize()
            (h0, e0), (h1, e1) = marks
            host += (h1 - h0) * 1e3 / iters
            card += e0.elapsed_time(e1) / iters
    finally:
        seg_scan._k1 = k1
        for h in hooks:
            h.remove()
    print(f"vfe (eval, batch 2, {chip_smoke.POINTS} points, mean of {iters}): host issues it in "
          f"{host:.4f} ms, card {card:.4f} ms between its start and end; K1 wrappers "
          f"{k1_host[0] * 1e3 / iters:.4f} ms of host time in {k1_host[1] / iters:.0f} calls",
          flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("k1_path: no CUDA device")
    dev = torch.device("cuda", 0)
    repeat = int(argv[argv.index("--repeat") + 1]) if "--repeat" in argv else 2
    what = [a for a in argv if a in ("parity", "vfe")] or ["parity", "vfe"]
    routes = (argv[argv.index("--routes") + 1].split(",") if "--routes" in argv
              else list(ROUTES))
    if "parity" in what:
        parity(dev, repeat, "--shift" in argv, routes, "--deterministic" in argv)
    if "vfe" in what:
        vfe_times(dev)


if __name__ == "__main__":
    main()
