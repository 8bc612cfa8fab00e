"""MPPNetE2E against the JAX package on the CPU (setup:
``tests/torch_port_centerhead_setup.py``, ``mppnet_e2e_memorybank_
inference.yaml`` narrowed): MPPNet's transformer (8 frames fused into 4
groups) to 1e-5; the multi-frame ``MPPNetHead``
on ``tests/test_mppnet.py``'s scene to 1e-4; ``generate_trajectory_with_idx``
(the matched indices, the linked rows and the validity exactly); the
memory bank's start and roll exactly; the single-frame eval step (the
CenterHead's top 16 RoIs, the memory-bank head's boxes and scores, the
final NMS's detections) to 1e-4, and the port's first stream step equal to
it; a 3-frame stream through ``mppnet_e2e_stream_step`` (the head's
outputs and the bank's features a step) to 1e-4.  One JAX jit of the
detector's forward, one of the stream step (the memory-bank head) and one
of the multi-frame head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.mppnet import init_bank as jax_init_bank
from com_tpu.models.mppnet import mppnet_e2e_stream_step as jax_stream_step
from com_tpu.models.mppnet import push_bank as jax_push_bank
from com_tpu.models.mppnet.mppnet_e2e import MPPNetHeadE2E as JaxMPPNetHeadE2E
from com_tpu.models.mppnet.mppnet_head import (
    generate_trajectory_with_idx as jax_generate_trajectory_with_idx)
from com_tpu.models.mppnet.transformer import MPPNetTransformer as JaxMPPNetTransformer
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu_torch.models.mppnet import init_bank, mppnet_e2e_stream_step, push_bank
from com_tpu_torch.models.mppnet.mppnet_head import generate_trajectory_with_idx
from com_tpu_torch.models.mppnet.transformer import MPPNetTransformer
from com_tpu_torch.train.eval import make_eval_step, make_stream_step
from com_tpu_torch.utils.jax_weights import _mppnet_head_rules
from test_torch_port_parta2 import Replay
from test_torch_port_slice import _match
from torch_port_centerhead_setup import INPUT_KEYS, flax_transforms, setup

torch.set_num_threads(2)
ATOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("frames,stride", [(8, 4)])
def test_transformer_matches_jax(frames, stride):
    """The grouped encoder (3 layers, 4 heads, 4 groups, a 2^3 proxy grid,
    positions on the keys) on seeded features, its weights the port's
    default init with the norms' and the token's moved: the final tokens
    and every layer's to 1e-5.  8 frames: the groups are the strided
    frames fused by ``fusion_all_group`` and ``fusion_norm`` (4 frames, a
    group each, run inside both heads below)."""
    c, p, g = 32, 8, 4
    torch.manual_seed(5)
    net = MPPNetTransformer(c, 4, 3, 64, p, g, frames, stride, mixer_hidden=8, grid_size=2,
                            dropout=0.1).eval()
    with torch.no_grad():
        for name, prm in net.named_parameters():
            if "norm" in name or name == "token":
                prm.add_(0.3 * torch.randn(prm.shape))
    tcfg = {"num_groups": g, "num_frames": frames, "enc_layers": 3, "nheads": 4}
    cfg = {"Transformer": tcfg, "ROI_GRID_POOL": {"MLPS": []}, "NAME": "MPPNetHeadE2E"}
    sd = {f"roi_head.transformer.{k}": v.numpy() for k, v in net.state_dict().items()}
    to_flax = flax_transforms(4)
    params = {}
    for key, _, path, transform in _mppnet_head_rules(cfg, "roi_head"):
        if key in sd:
            node = params
            for part in path[2:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = to_flax[transform](sd[key])
    assert len(jax.tree_util.tree_leaves(params)) == len(sd)
    rng = np.random.RandomState(frames)
    src = rng.randn(6, frames * p, c).astype(np.float32)
    pos = rng.randn(1 + p, c).astype(np.float32)
    jnet = JaxMPPNetTransformer(d_model=c, nhead=4, num_encoder_layers=3, dim_feedforward=64,
                                num_proxy_points=p, num_groups=g, num_frames=frames,
                                sequence_stride=stride, mixer_hidden=8, grid_size=2)
    jhs, jtokens = jax.jit(lambda v, s, q: jnet.apply(v, s, pos=q))({"params": params}, src, pos)
    with torch.no_grad():
        hs, tokens = net(t(src), t(pos))
    assert hs.shape == (g, 6, c) and len(tokens) == 3
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=1e-5, atol=1e-5)
    for got, want in zip(tokens, jtokens):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def sequence(rng, b=2, r=12, f=4):
    """Current boxes with a backward displacement each, and each frame's
    proposals: every box moved back by it frame by frame (a few cm of
    noise), shuffled, some missing and some far off."""
    cur = np.zeros((b, r, 9), np.float32)
    cur[..., 0:2] = rng.uniform(-20, 20, (b, r, 2))
    cur[..., 2] = rng.uniform(-0.5, 1.0, (b, r))
    cur[..., 3:6] = rng.uniform(1.0, 4.5, (b, r, 3))
    cur[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    cur[..., 7:9] = rng.uniform(-0.8, 0.8, (b, r, 2))
    props = np.repeat(cur[:, None], f, 1)
    for i in range(1, f):
        props[:, i, :, 0:2] = cur[..., 0:2] + i * cur[..., 7:9]
        props[:, i, :, 0:3] += rng.normal(0, 0.03, (b, r, 3))
        gone = rng.rand(b, r) < 0.25
        props[:, i][gone, 0:2] += 50.0
        for j in range(b):
            props[j, i] = props[j, i][rng.permutation(r)]
    return cur, props.astype(np.float32)


def test_generate_trajectory_with_idx_matches_jax():
    """Each frame's matched proposal index (-1 where no proposal reaches
    IoU 0.5), the trajectory's rows and the validity exactly, with some
    boxes of each frame unmatched."""
    cur, props = sequence(np.random.RandomState(11))
    want = jax.jit(jax_generate_trajectory_with_idx)(cur, props)
    got = generate_trajectory_with_idx(t(cur), t(props))
    idx = got[2].numpy()
    np.testing.assert_array_equal(idx, np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (idx[:, 1:] == -1).any() and (idx[:, 1:] >= 0).mean() > 0.5


def test_memory_bank_rolls_as_jax():
    """``init_bank`` repeats the first frame into every slot; ``push_bank``
    puts the newest in slot 0 and drops the oldest: each field exactly, as
    the JAX bank's."""
    rng = np.random.RandomState(2)
    frames = [[rng.randn(2, 5, 9), rng.randint(1, 4, (2, 5)), rng.rand(2, 5),
               rng.randn(2, 5, 8, 16)] for _ in range(4)]
    frames = [[a.astype(np.float32) if a.dtype == np.float64 else a for a in fr]
              for fr in frames]
    jbank = jax_init_bank(*(jnp.asarray(a) for a in frames[0]), 3)
    bank = init_bank(*(t(a) for a in frames[0]), 3)
    for fr in frames[1:]:
        jbank = jax_push_bank(jbank, *(jnp.asarray(a) for a in fr))
        bank = push_bank(bank, *(t(a) for a in fr))
        for got, want in zip(bank, jbank):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bank.geo.shape == (2, 3, 5, 8, 16)
    np.testing.assert_array_equal(bank.rois[:, 0].numpy(), frames[3][0])
    np.testing.assert_array_equal(bank.rois[:, 2].numpy(), frames[1][0])


def test_mppnet_head_matches_jax():
    """MPPNet's multi-frame head (``MPPNetHead``: the crop of every frame,
    the geometry and motion features, the per-group boxes) on
    ``tests/test_mppnet.py``'s scene (a moving and a static box over 4
    frames, distractors), its weights the port's default init with the
    box norms' statistics moved: the class logits of every layer, the
    joint, per-group and sequence regressions and the decoded boxes to
    1e-4."""
    import copy

    from com_tpu.models.mppnet import MPPNetHead as JaxMPPNetHead
    from com_tpu_torch.models.mppnet import MPPNetHead
    from test_mppnet import HEAD_CFG, make_scene

    cfg = dict(copy.deepcopy(HEAD_CFG), NAME="MPPNetHead")
    cfg["Transformer"]["enc_layers"] = 2  # a fusing layer and the last
    _, proposals, _, _, points, pmask = make_scene(np.random.RandomState(5))
    torch.manual_seed(8)
    head = MPPNetHead(cfg, num_point_features=points.shape[-1]).eval()
    with torch.no_grad():
        for name, buf in head.named_buffers():
            if "running" in name:
                buf.copy_(torch.rand(buf.shape) + (0.5 if "var" in name else -0.5))
    sd = {f"roi_head.{k}": v.numpy() for k, v in head.state_dict().items()}
    to_flax = flax_transforms(int(cfg["Transformer"]["nheads"]))
    variables = {"params": {}, "batch_stats": {}}
    for key, coll, path, transform in _mppnet_head_rules(cfg, "roi_head"):
        node = variables[coll]
        for part in path[1:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = to_flax[transform](sd[key])
    # the port's linking (held to JAX's above): JAX's runs unjitted for seconds
    traj, valid, _ = generate_trajectory_with_idx(t(proposals[:, 0]), t(proposals))
    batch = {"trajectory_rois": traj.numpy(), "valid_length": valid.numpy(),
             "points": np.asarray(points), "points_mask": np.asarray(pmask)}
    jhead = JaxMPPNetHead(model_cfg=cfg, num_class=1)
    want = jax.jit(lambda v, b: jhead.apply(v, b, train=False))(variables, batch)
    with torch.no_grad():
        got = head({k: t(v) for k, v in batch.items()})
    assert got["mppnet_preds"]["point_reg"].shape == (8, 10, 7)
    for k in ("rcnn_cls", "rcnn_reg", "point_reg", "box_reg"):
        np.testing.assert_allclose(got["mppnet_preds"][k].numpy(),
                                   np.asarray(want["mppnet_preds"][k]), rtol=ATOL, atol=ATOL,
                                   err_msg=k)
    for k in ("batch_cls_preds", "batch_box_preds"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=ATOL, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def mppnet():
    """The setup, the JAX eval forward's outputs and its eval step's
    detections of them, the port's eval forward."""
    s = setup("mppnet")
    cfg, jmeta, _, jnet, variables, net, host = s
    keys = INPUT_KEYS["mppnet"]
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, {k: host[k] for k in keys})
    normalized = bool(jout.pop("cls_preds_normalized"))  # a Python flag in the forward
    jdet = jax.jit(lambda o: jax_make_eval_step(
        Replay(dict(o, cls_preds_normalized=normalized)), cfg.MODEL, list(cfg.CLASS_NAMES),
        jmeta)(None, {}))(jout)
    jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.no_grad():
        out = net({k: t(host[k]) for k in keys})
    return s, jout, [np.asarray(d) for d in jdet], out


def test_mppnet_e2e_eval_step_matches_jax(mppnet):
    """One frame with no bank (a zero bank over the RoIs): the CenterHead's
    top 16 boxes with their velocities, labels and validity, the head's
    trajectories, boxes and class logits to 1e-4, the detections of the
    final NMS (paired nearest) to 1e-4; the port's first stream step
    (``make_stream_step``) gives the eval step's detections bitwise."""
    (cfg, _, pmeta, _, _, net, host), jout, jdet, out = mppnet
    assert out["rois"].shape == (2, 16, 9)
    for k in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=k)
    for k in ("rois", "roi_scores", "trajectory_rois", "batch_box_preds", "batch_cls_preds"):
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=ATOL, atol=ATOL, err_msg=k)
    names = list(cfg.CLASS_NAMES)
    step = make_eval_step(net, cfg.MODEL, names, pmeta, device="cpu")
    det = [g.numpy() for g in step(host)]
    boxes, scores, labels, valid = det
    jb, js, jl, jv = jdet
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 4
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one
    first, bank = make_stream_step(net, cfg.MODEL, names, pmeta, device="cpu")(host, None, True)
    for got, want in zip(first, det):
        np.testing.assert_array_equal(got.numpy(), want)
    assert bank.geo.shape == (2, 4, 16, 8, 32) and float(bank.geo[:, 0].abs().max()) > 0
    assert float(bank.geo[:, 1:].abs().max()) == 0.0


def test_mppnet_e2e_stream_matches_jax(mppnet):
    """Three frames through the memory-bank head in both packages
    (``mppnet_e2e_stream_step``): frame 0's proposals the eval forward's
    RoIs, frames 1 and 2 those boxes moved forward by their velocity (a few
    cm of noise, shuffled); each step's trajectories exactly, its boxes,
    class logits and current features, and the bank's features, to 1e-4;
    later steps gather banked features."""
    (cfg, _, _, _, variables, net, host), jout, _, _ = mppnet
    head_cfg = cfg.MODEL.ROI_HEAD
    jhead = JaxMPPNetHeadE2E(model_cfg=head_cfg, num_class=1)
    jvars = {c: variables[c]["roi_head"] for c in ("params", "batch_stats")}
    rng = np.random.RandomState(4)
    rois = jout["rois"]
    frames = [rois]
    for _ in range(2):
        prev = frames[-1].copy()
        prev[..., 0:2] -= prev[..., 7:9]
        prev[..., 0:3] += rng.normal(0, 0.02, prev[..., 0:3].shape).astype(np.float32)
        frames.append(prev[:, rng.permutation(prev.shape[1])])
    # the JAX step jitted once, for a later frame: frame 0 rolls onto JAX's
    # init_bank of frame 0 with zero features, the bank its first-frame
    # branch starts from (every slot frame 0's, the pushed slot's features
    # zero), and the port's runs its own first-frame branch
    rest = jax.jit(lambda v, b, bk: jax_stream_step(jhead, v, b, bk, False))
    jbank = jax_init_bank(*(jnp.asarray(jout[k]) for k in ("rois", "roi_labels", "roi_scores")),
                          jnp.zeros((*rois.shape[:2], 8, 32), jnp.float32), 4)
    bank = None
    matched = 0
    for f, fr in enumerate(frames):
        batch = {"rois": fr, "roi_scores": jout["roi_scores"], "roi_labels": jout["roi_labels"],
                 "points": host["points"], "points_mask": host["points_mask"]}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jo, jbank = rest(jvars, jb, jbank)
        with torch.no_grad():
            o, bank = mppnet_e2e_stream_step(net.roi_head, {k: t(v) for k, v in batch.items()},
                                             bank, f == 0)
        np.testing.assert_array_equal(o["trajectory_rois"].numpy(),
                                      np.asarray(jo["trajectory_rois"]))
        for k in ("batch_box_preds", "batch_cls_preds", "geometry_feature_memory"):
            np.testing.assert_allclose(o[k].numpy(), np.asarray(jo[k]), rtol=ATOL, atol=ATOL,
                                       err_msg=f"frame {f} {k}")
        np.testing.assert_allclose(bank.geo.numpy(), np.asarray(jbank.geo), rtol=ATOL, atol=ATOL)
        matched += int(o["valid_length"][:, 1:].sum()) if f > 0 else 0
    assert matched > 0 and float(bank.geo[:, 2].abs().max()) > 0
