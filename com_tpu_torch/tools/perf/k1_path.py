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

``kinks``: what decides that comparison.  The CPU step records its
decisions at the net's kinks: the sign of every ReLU's input, and the set of
tied maxima of every K1 max (its backward) and of the last PFN layer's
canvas max (a library scatter-max).  The card step (K1's kernels) is then
run with nothing imposed, counting, layer by layer, the units whose ReLU
input has the other sign on the card (with the largest |input| among them
beside the largest card-against-CPU difference of the layer's inputs and
their RMS) and the (run, channel) pairs whose set of tied
maxima differs; then once more for each of ``relu``, ``max`` and
``relu,max`` with the CPU's decisions imposed (a ReLU passes x where the
CPU's input was positive; a max splits its gradient over the CPU's tied
set), printing the test's worst ratios each time.

``vfe``: the flagship VFE in one full-width eval step (batch 2, 163,840
Waymo-like points a scene, 468x468): the host's time from the VFE's start
to its return (it queues the work and does not wait for the card), the
card's time between the same two points (CUDA events), and the host time
spent inside the K1 wrappers, means over the steps.

    python -m com_tpu_torch.tools.perf.k1_path [parity] [kinks] [vfe] [--repeat N] [--shift]
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


def step_grads(device, shift: bool, on_net=None):
    """Loss, gradients and batch statistics of one f32 train step from the
    test's weights (seed 3) on ``device``; ``on_net(net)`` is called once the
    net is built."""
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
    if on_net is not None:
        on_net(net)
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


def _library_modes(deterministic: bool):
    """TF32 off, as in the test; with ``deterministic`` the library's ops in
    their deterministic versions, and a warning at each op that has none."""
    import warnings

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        warnings.simplefilter("always")


def parity(dev, repeat: int, shift: bool, routes, deterministic=False):
    _library_modes(deterministic)
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


def _run_pairs(diff, seg):
    """(run, channel) pairs and runs in which ``diff`` (B, N, C) holds a
    true row."""
    hit = seg_scan.run_bcast_plain(diff.float(), seg, "sum") > 0
    first = torch.ones(seg.shape, dtype=torch.bool, device=seg.device)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    return int((hit & first[..., None]).sum()), int((hit.any(-1) & first).sum())


class _ImposedAmax(torch.autograd.Function):
    """A scatter-max whose gradient goes to a given tied set: each source
    element in ``tied`` takes its slot's gradient over the slot's count."""

    @staticmethod
    def forward(ctx, out, dim, index, src, tied):
        ctx.save_for_backward(index, tied)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, g):
        index, tied = ctx.saved_tensors
        cnt = torch.zeros_like(g).scatter_add_(ctx.dim, index, tied.to(g.dtype))
        share = (g / cnt.clamp_min(1.0)).gather(ctx.dim, index)
        return None, None, None, share * tied.to(g.dtype), None


class KinkRecorder:
    """The step's decisions at its kinks, in call order: the sign of each
    ReLU's input (``torch.relu`` in the PFN layers, ``nn.ReLU`` elsewhere)
    and the tied maxima of each K1 max's backward and of each scatter-max
    that carries a gradient (the last PFN layer's canvas).  Without ``ref``
    it records them; given a recording (the CPU step's), it counts where
    this step decides otherwise, and takes the recording's decision at the
    kinds named in ``impose`` ("relu", "max")."""

    def __init__(self, ref=None, impose=()):
        self.ref, self.impose = ref, set(impose)
        self.relu, self.ties = [], []   # ReLU inputs and tied-max masks (CPU), in call order
        self.report = []                # lines: where this step decides otherwise
        self.current = "?"
        self._hooks = []

    def on_net(self, net):
        """Name each ReLU call by the module it runs in."""
        from torch import nn

        from com_tpu_torch.models.vfe import PFNLayer

        for name, mod in net.named_modules():
            if isinstance(mod, (nn.ReLU, PFNLayer)):
                label = f"{name}.relu" if isinstance(mod, PFNLayer) else name
                self._hooks.append(mod.register_forward_pre_hook(
                    lambda *_, label=label: setattr(self, "current", label)))

    def _relu(self, x, inplace=False):
        i = len(self.relu)
        self.relu.append(x.detach().cpu())
        if self.ref is None:
            return self._orig_relu(x)
        ref_x = self.ref.relu[i].to(x.device)
        want = ref_x > 0
        flip = (x > 0) != want
        n = int(flip.sum())
        xd = x.detach()
        rms = float(xd.float().pow(2).mean().sqrt())
        worst = float(xd.abs()[flip].max()) if n else 0.0
        apart = float((xd - ref_x).abs().max())
        self.report.append(f"relu {self.current} {tuple(x.shape)}: {n} of {x.numel()} units "
                           f"flipped, largest |input| among them {worst:.3g}; inputs apart "
                           f"by at most {apart:.3g} (layer rms {rms:.3g})")
        if "relu" in self.impose:
            return x * want.to(x.dtype)
        return self._orig_relu(x)

    def _tied(self, what, tied, seg=None):
        i = len(self.ties)
        self.ties.append(tied.cpu())
        if self.ref is None:
            return tied
        want = self.ref.ties[i].to(tied.device)
        diff = tied != want
        if seg is not None:
            pairs, runs = _run_pairs(diff, seg)
            self.report.append(f"{what} {tuple(tied.shape)}: tied set differs in {pairs} "
                               f"(run, channel) pairs of {runs} runs")
        else:
            self.report.append(f"{what} {tuple(tied.shape)}: {int(diff.sum())} source "
                               f"elements tied on one side only")
        return want if "max" in self.impose else tied

    def _max_bwd(self, g, vals, out, seg):
        tied = self._tied("K1 max backward", vals == out, seg)
        if self.ref is None or "max" not in self.impose:
            return self._orig_max_bwd(g, vals, out, seg)
        tied = tied.float()
        gsum = seg_scan.run_bcast_plain(g.float(), seg, "sum")
        nties = seg_scan.run_bcast_plain(tied, seg, "sum")
        return (tied * gsum / torch.clamp(nties, min=1.0)).to(vals.dtype)

    def _scatter_reduce_(self, canvas, dim, index, src, reduce, *, include_self=True):
        if reduce != "amax" or not src.requires_grad:
            return self._orig_scatter(canvas, dim, index, src, reduce, include_self=include_self)
        with torch.no_grad():
            out = self._orig_scatter(canvas.clone(), dim, index, src, reduce,
                                     include_self=include_self)
        tied = self._tied("canvas max", src.detach() == out.gather(dim, index))
        return canvas.copy_(_ImposedAmax.apply(out, dim, index, src, tied))

    def __enter__(self):
        import torch.nn.functional as F

        self._orig_relu, self._orig_F_relu = torch.relu, F.relu
        self._orig_max_bwd = seg_scan.run_bcast_max_bwd
        self._orig_scatter = torch.Tensor.scatter_reduce_
        torch.relu = F.relu = self._relu
        seg_scan.run_bcast_max_bwd = self._max_bwd
        torch.Tensor.scatter_reduce_ = lambda t, *a, **kw: self._scatter_reduce_(t, *a, **kw)
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        torch.relu = self._orig_relu
        F.relu = self._orig_F_relu
        seg_scan.run_bcast_max_bwd = self._orig_max_bwd
        torch.Tensor.scatter_reduce_ = self._orig_scatter
        for h in self._hooks:
            h.remove()


def kinks(dev, shift: bool, deterministic=False):
    _library_modes(deterministic)
    with KinkRecorder() as ref:
        cpu = step_grads("cpu", shift, ref.on_net)
    for impose in ((), ("relu",), ("max",), ("relu", "max")):
        with KinkRecorder(ref, impose) as rec:
            card = step_grads(dev, shift, rec.on_net)
        torch.cuda.synchronize()
        r = ratios(card, cpu)
        worst = sorted(r.items(), key=lambda kv: -kv[1])[:3]
        verdict = "passes" if worst[0][1] <= 1 else "FAILS"
        print(f"kinks shift={int(shift)} imposed={','.join(impose) or 'none'}: {verdict}; "
              f"card step {_fingerprint(card)}; worst "
              + ", ".join(f"{k} {v:.3f}" for k, v in worst), flush=True)
        if not impose:
            for line in rec.report:
                print(f"    {line}", flush=True)


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
    what = [a for a in argv if a in ("parity", "kinks", "vfe")] or ["parity", "vfe"]
    routes = (argv[argv.index("--routes") + 1].split(",") if "--routes" in argv
              else list(ROUTES))
    if "parity" in what:
        parity(dev, repeat, "--shift" in argv, routes, "--deterministic" in argv)
    if "kinks" in what:
        kinks(dev, "--shift" in argv, "--deterministic" in argv)
    if "vfe" in what:
        vfe_times(dev)


if __name__ == "__main__":
    main()
