"""The port's two-stage building blocks against the JAX package on the CPU:
the rotated 3D IoU and the corner loss, ``voxel_query`` (both modes, both
lookup structures), the RoI grid points, the bilinear and rotated RoI
sampling of SECOND-IoU's head, the proposal layer, RoI target assignment
in both branches (the random one on the JAX package's own uniforms) and
the canonical transform with its inverse.

Inputs are numpy from a seed.  Indices and masks must be equal exactly;
values agree to 1e-5 (1e-6 where nothing but a gather or an affine map
stands between them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.roi_heads import proposal_layer as jpl
from com_tpu.models.roi_heads import roi_targets as jrt
from com_tpu.models.roi_heads import second_head as jsh
from com_tpu.models.roi_heads.pvrcnn_head import roi_grid_points as j_roi_grid_points
from com_tpu.ops import boxes as jboxes
from com_tpu.ops import iou as jiou
from com_tpu.ops import sparse as js
from com_tpu_torch.models.roi_heads import proposal_layer as ppl
from com_tpu_torch.models.roi_heads import roi_targets as prt
from com_tpu_torch.models.roi_heads import second_head as psh
from com_tpu_torch.models.roi_heads.pvrcnn_head import roi_grid_points
from com_tpu_torch.ops import boxes as pboxes
from com_tpu_torch.ops import iou as piou
from com_tpu_torch.ops import sparse as ps
from com_tpu_torch.utils.registry import ROI_HEADS
from tests.test_sparse_conv import random_sparse

torch.set_num_threads(2)
SIZES = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, n, spread=8.0):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.5, n)
    b[:, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def jitter(rng, boxes, pos=0.3, size=0.1, yaw=0.3):
    out = boxes.copy()
    out[..., :3] += rng.normal(0, pos, out[..., :3].shape)
    out[..., 3:6] *= rng.uniform(1 - size, 1 + size, out[..., 3:6].shape)
    out[..., 6] += rng.normal(0, yaw, out[..., 6].shape)
    return out.astype(np.float32)


def test_boxes_iou3d_and_overlap_match_jax():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, 40, 4.0)
    b = np.concatenate([jitter(rng, a[:20]), random_boxes(rng, 12, 4.0),
                        np.zeros((3, 7), np.float32)])  # overlapping, apart, padded
    want = np.asarray(jiou.boxes_iou3d(jnp.asarray(a), jnp.asarray(b), xp=jnp))
    got = piou.boxes_iou3d(t(a), t(b)).numpy()
    assert (want > 0.3).sum() > 10
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(piou.boxes_overlap_bev(t(a), t(b)).numpy(),
                               np.asarray(jiou.boxes_overlap_bev(jnp.asarray(a), jnp.asarray(b),
                                                                 xp=jnp)), atol=1e-5, rtol=1e-5)
    # leading batch axes
    batched = piou.boxes_iou3d(t(np.stack([a, a])), t(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[1], got)


def test_corners_and_corner_loss_match_jax():
    rng = np.random.RandomState(1)
    gt = random_boxes(rng, 50)
    pred = jitter(rng, gt, pos=0.5, yaw=0.8)
    pred[:10, 6] = gt[:10, 6] + np.pi  # the flipped heading costs nothing
    np.testing.assert_allclose(pboxes.boxes_to_corners_3d(t(gt)).numpy(),
                               np.asarray(jboxes.boxes_to_corners_3d(jnp.asarray(gt), xp=jnp)),
                               atol=1e-6)
    want = np.asarray(jboxes.corner_loss(jnp.asarray(pred), jnp.asarray(gt), xp=jnp))
    got = pboxes.corner_loss(t(pred), t(gt)).numpy()
    assert (want > 0.5).any() and (want < 0.5).any()  # both sides of the Huber kink
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_points_in_rbbox_matches_jax():
    rng = np.random.RandomState(2)
    boxes = random_boxes(rng, 12, 3.0)
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    want = np.asarray(jboxes.points_in_rbbox(jnp.asarray(pts), jnp.asarray(boxes), xp=jnp))
    got = pboxes.points_in_rbbox(t(pts), t(boxes)).numpy()
    assert want.sum() > 20
    np.testing.assert_array_equal(got, want)


def vq_scene(seed, grid, n, pad=10):
    rng = np.random.RandomState(seed)
    coords, _ = random_sparse(rng, grid, n, 1)
    coords = np.concatenate([coords, np.full((pad, 3), -1, np.int32)])
    return coords, np.arange(n + pad) < n


def vq_queries(seed, grid, s=300):
    """Queries inside the grid, at its edges and a cell past them."""
    rng = np.random.RandomState(seed)
    hi = np.asarray(grid, np.float32)
    q = rng.uniform(0, 1, (s, 3)).astype(np.float32) * hi
    q[:40] = np.where(rng.rand(40, 3) < 0.5, rng.uniform(-1.0, 0.5, (40, 3)),
                      hi - rng.uniform(-1.0, 0.5, (40, 3))).astype(np.float32)
    return q


@pytest.fixture(params=["dense", "sorted"])
def lookup(request, monkeypatch):
    monkeypatch.setattr(ps, "DENSE_CELL_CAP", 10**12 if request.param == "dense" else 0)
    return request.param


@pytest.mark.parametrize("mode", ["metric", "metric_anisotropic", "legacy"])
def test_voxel_query_equals_jax(mode, lookup):
    """idx, empty and slot_valid exactly; dense scenes so that many queries
    have more hits than ``nsample``."""
    grid = (6, 14, 12)
    coords, valid = vq_scene(3, grid, 500)
    q = vq_queries(4, grid)
    kw = {"metric": dict(max_range=2, nsample=6, cell_zyx=(0.4, 0.4, 0.4), radius_world=0.8),
          "metric_anisotropic": dict(max_range=3, nsample=8, cell_zyx=(0.2, 0.1, 0.1),
                                     radius_world=0.25),
          "legacy": dict(max_range=2, radius_vox=2.0, nsample=5)}[mode]
    want = js.voxel_query(jnp.asarray(q), jnp.asarray(coords), jnp.asarray(valid), grid, **kw)
    got = ps.voxel_query(t(q), t(coords), t(valid), grid, **kw)
    for g, w, name in zip(got, want, ("idx", "empty", "slot_valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    slot = got[2].numpy()
    assert slot.all(1).sum() > 30 and got[1].numpy().sum() > 0  # full balls and empty ones
    assert valid[got[0].numpy()[slot]].all()  # real hits are occupied sites


def test_voxel_query_chunking_and_batch():
    """The chunk size changes nothing; each scene of a batch queries only
    its own sites."""
    grid = (5, 10, 10)
    scenes = [vq_scene(s, grid, 250) for s in (5, 6)]
    q = np.stack([vq_queries(s, grid, 120) for s in (7, 8)])
    c = np.stack([sc[0] for sc in scenes])
    v = np.stack([sc[1] for sc in scenes])
    kw = dict(max_range=2, nsample=7, cell_zyx=(0.3, 0.2, 0.2), radius_world=0.5)
    outs = [ps.batched_voxel_query(t(q), t(c), t(v), grid, chunk=ch, **kw) for ch in (1, 7, 512)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    for i in range(2):
        one = ps.voxel_query(t(q[i]), t(c[i]), t(v[i]), grid, **kw)
        for a, b in zip(outs[0], one):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())


def test_query_offsets_match_the_jax_scan_order():
    """Voxel-RCNN's KITTI scales keep 387 of the 729 offsets, nearest first."""
    vs = (0.05, 0.05, 0.1)
    for stride, radius in ((2, 0.4), (4, 0.8), (8, 1.6)):
        offs = ps.query_offsets(4, cell_zyx=(vs[2] * stride, vs[1] * stride, vs[0] * stride),
                                radius_world=radius)
        assert offs.shape == (387, 3)
        np.testing.assert_array_equal(offs[0], [0, 0, 0])


def test_roi_grid_points_match_jax():
    rois = random_boxes(np.random.RandomState(9), 20)
    want = np.asarray(j_roi_grid_points(jnp.asarray(rois), 3))
    got = roi_grid_points(t(rois), 3).numpy()
    assert got.shape == (20, 27, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(roi_grid_points(t(np.stack([rois] * 2)), 3).numpy()[1], got)


def test_bilinear_and_rotated_roi_sample_match_jax():
    rng = np.random.RandomState(10)
    fmap = rng.randn(2, 12, 10, 5).astype(np.float32)
    px = rng.uniform(-2, 12, (2, 40)).astype(np.float32)  # past both edges
    py = rng.uniform(-2, 14, (2, 40)).astype(np.float32)
    got = psh.bilinear_sample(t(fmap), t(px), t(py)).numpy()
    for i in range(2):
        want = np.asarray(jsh.bilinear_sample(jnp.asarray(fmap[i]), jnp.asarray(px[i]),
                                              jnp.asarray(py[i])))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=1e-5)
    pc_range, vsize = (0.0, -4.0, -3.0, 8.0, 4.0, 1.0), (0.4, 0.4, 0.1)
    rois = random_boxes(rng, 2 * 9, 3.0).reshape(2, 9, 7)
    rois[..., 0] += 4.0
    got = psh.rotated_roi_grid_sample(t(fmap), t(rois), pc_range, vsize, 2.0, 4).numpy()
    assert got.shape == (2, 9, 4, 4, 5)
    for i in range(2):
        want = np.asarray(jsh.rotated_roi_grid_sample(jnp.asarray(fmap[i]), jnp.asarray(rois[i]),
                                                      pc_range, vsize, 2.0, 4))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=1e-5)
    # a bf16 map samples to f32, as flax promotes it
    bf = psh.bilinear_sample(t(fmap).to(torch.bfloat16), t(px), t(py))
    assert bf.dtype == torch.float32


def test_second_iou_loss_and_fusion_match_jax():
    rng = np.random.RandomState(11)
    iou = rng.randn(2, 16).astype(np.float32)
    labels = rng.uniform(-0.2, 1.0, (2, 16)).astype(np.float32)
    labels[labels < 0] = -1.0

    class T:
        cls_labels = None

    for kind in ("BinaryCrossEntropy", "L2", "smoothL1"):
        cfg = {"IOU_LOSS": kind, "LOSS_WEIGHTS": {"rcnn_iou_weight": 2.0}}
        jt, pt = T(), T()
        jt.cls_labels, pt.cls_labels = jnp.asarray(labels), t(labels)
        want = float(jsh.second_iou_loss({"rcnn_iou": jnp.asarray(iou), "roi_targets": jt}, cfg))
        got = float(psh.second_iou_loss({"rcnn_iou": t(iou), "roi_targets": pt}, cfg))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), kind
    npts = rng.randint(0, 150, (2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        psh.fuse_scores_by_npoints(t(iou), t(labels), t(npts)).numpy(),
        np.asarray(jsh.fuse_scores_by_npoints(jnp.asarray(iou), jnp.asarray(labels),
                                              jnp.asarray(npts))), atol=1e-6)


def proposals(seed, b=2, n=300):
    """Candidates in clusters (so NMS suppresses), scores rounded to 0.01
    (ties), 150 of them -inf (not candidates, some within the top 200) a
    scene."""
    rng = np.random.RandomState(seed)
    centres = random_boxes(rng, 20, 10.0)
    boxes = np.stack([jitter(rng, centres[rng.randint(0, 20, n)], pos=0.4, yaw=0.2)
                      for _ in range(b)])
    scores = np.round(rng.rand(b, n), 2).astype(np.float32)
    scores[:, rng.choice(n, 150, replace=False)] = -np.inf
    labels = rng.randint(1, 4, (b, n)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("fast", [False, True])
def test_proposal_layer_matches_jax(fast):
    boxes, scores, labels = proposals(12)
    want = jpl.proposal_layer(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                              nms_pre=200, nms_post=200, nms_thresh=0.5, use_fast_nms=fast)
    got = ppl.proposal_layer(t(boxes), t(scores), t(labels), nms_pre=200, nms_post=200,
                             nms_thresh=0.5, use_fast_nms=fast)
    rois, sc, lb, v = (g.numpy() for g in got)
    jr, js_, jl, jv = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(v, jv)
    assert 10 < v.sum(1).min() and v.sum(1).max() < 140  # suppression and padding
    assert np.isnan(sc).any()
    np.testing.assert_array_equal(rois, jr)
    np.testing.assert_array_equal(sc, js_)  # NaN in the same slots (-inf * 0)
    np.testing.assert_array_equal(lb, jl)
    assert lb.dtype == np.int32


def assign_inputs(seed, b=2, p=48, m=8):
    """Proposals around the GT (some foreground, hard and easy backgrounds),
    class-aware labels, invalid slots, GT padding."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, m, 8), np.float32)
    rois = np.zeros((b, p, 7), np.float32)
    for i in range(b):
        k = m - 2
        cls = rng.randint(1, 4, k)
        gt[i, :k, :7] = random_boxes(rng, k, 10.0)
        gt[i, :k, 3:6] = SIZES[cls - 1]
        gt[i, :k, 7] = cls
        src = rng.randint(0, k, p)
        rois[i] = jitter(rng, gt[i, src, :7], pos=rng.choice([0.1, 0.5, 1.5], p)[:, None],
                         yaw=0.2)
        rois[i, -6:] = random_boxes(rng, 6, 10.0)
    other = gt[np.arange(b)[:, None], rng.randint(0, m - 2, (b, p)), 7]
    labels = np.where(rng.rand(b, p) < 0.8, other, 1).astype(np.int32)
    scores = rng.rand(b, p).astype(np.float32)
    valid = rng.rand(b, p) < 0.9
    return rois, scores, labels, valid, gt


def check_targets(got, want):
    for name, g, w in zip(prt.RoITargets._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == bool or g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


KW = dict(roi_per_image=16, fg_ratio=0.5, reg_fg_thresh=0.55, cls_fg_thresh=0.75,
          cls_bg_thresh=0.25, cls_bg_thresh_lo=0.1, hard_bg_ratio=0.8)


def test_assign_roi_targets_deterministic_matches_jax():
    rois, scores, labels, valid, gt = assign_inputs(13)
    want = jrt.assign_roi_targets(*(jnp.asarray(a) for a in (rois, scores, labels, valid, gt)),
                                  **KW)
    got = prt.assign_roi_targets(*(t(a) for a in (rois, scores, labels, valid, gt)), **KW)
    check_targets(got, want)
    fg = got.reg_valid.numpy()
    assert 0 < fg.sum(1).min() and fg.sum(1).max() <= 8
    assert (got.cls_labels.numpy() > 0).any() and (got.cls_labels.numpy() == 0).any()


@pytest.mark.parametrize("seed", [14, 15])
def test_assign_roi_targets_random_on_jax_uniforms(seed):
    """The random branch fed the uniforms JAX draws from its key (one key a
    scene, ``jax.random.split``), and drawn from a torch generator."""
    rois, scores, labels, valid, gt = assign_inputs(seed)
    key = jax.random.PRNGKey(seed)
    want = jrt.assign_roi_targets(*(jnp.asarray(a) for a in (rois, scores, labels, valid, gt)),
                                  rng=key, **KW)
    u = np.stack([np.asarray(jax.random.uniform(k, (rois.shape[1],)))
                  for k in jax.random.split(key, rois.shape[0])])
    got = prt.assign_roi_targets(*(t(a) for a in (rois, scores, labels, valid, gt)), u=t(u),
                                 **KW)
    check_targets(got, want)
    det = prt.assign_roi_targets(*(t(a) for a in (rois, scores, labels, valid, gt)), **KW)
    assert not torch.equal(got.rois, det.rois)  # another selection than the deterministic one
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    d1 = prt.assign_roi_targets(*(t(a) for a in (rois, scores, labels, valid, gt)), generator=g1,
                                **KW)
    d2 = prt.assign_roi_targets(*(t(a) for a in (rois, scores, labels, valid, gt)), generator=g2,
                                **KW)
    assert torch.equal(d1.rois, d2.rois)


def test_canonical_transform_and_decode_round_trip():
    rng = np.random.RandomState(16)
    rois = random_boxes(rng, 64)
    gt = jitter(rng, rois, pos=0.5, yaw=1.0)
    gt[:16, 6] = rois[:16, 6] + rng.uniform(2.0, 4.0, 16)  # opposite headings: flipped
    # the clamp's edges: exactly a quarter and three quarters of a turn off
    gt[16:20, 6] = rois[16:20, 6] + np.float32(np.pi / 2)
    gt[20:24, 6] = rois[20:24, 6] - np.float32(np.pi / 2)
    gt[24:28, 6] = rois[24:28, 6] + np.float32(1.5 * np.pi)
    want = np.asarray(jrt.canonical_transform(jnp.asarray(gt), jnp.asarray(rois)))
    enc = prt.canonical_transform(t(gt), t(rois))
    np.testing.assert_allclose(enc.numpy(), want, atol=1e-5, rtol=1e-5)
    assert np.abs(enc.numpy()[:, 6]).max() <= np.pi / 2 + 1e-6
    dec = prt.decode_rcnn_boxes(t(rois), enc).numpy()
    np.testing.assert_allclose(dec[:, :6], gt[:, :6], atol=2e-5)
    turn = (dec[:, 6] - gt[:, 6]) / np.pi  # the same heading up to half turns
    np.testing.assert_allclose(turn, np.round(turn), atol=1e-5)
    np.testing.assert_allclose(
        dec, np.asarray(jrt.decode_rcnn_boxes(jnp.asarray(rois), jnp.asarray(want))), atol=2e-5)


@pytest.mark.parametrize("name", ["PVRCNNHead", "PVRCNNPlusPlusHead", "PartA2FCHead",
                                  "PointRCNNHead", "MPPNetHead"])
def test_unported_roi_heads_raise_by_name(name):
    """The unported heads raise by name; the PV-RCNN heads, ported, build
    from their defaults (the JAX heads' own), PointRCNN's, PartA2's and
    MPPNet's from ``tests/test_pointrcnn.py``'s, ``tests/test_parta2.py``'s
    and ``tests/test_mppnet.py``'s configs (the JAX heads have no default
    for their pools)."""
    if name == "MPPNetHead":
        from test_mppnet import HEAD_CFG

        head = ROI_HEADS.get(name)(HEAD_CFG, num_class=1, num_point_features=6)
        assert type(head).__name__ == name and len(head.bbox_embed) == 4
        return
    if name == "PartA2FCHead":
        from test_parta2 import parta2_cfg

        head = ROI_HEADS.get(name)(dict(parta2_cfg()["ROI_HEAD"]), num_class=1,
                                   input_channels=8)
        assert type(head).__name__ == name and head.pool_size == 4
        return
    if name.startswith("PVRCNN"):
        head = ROI_HEADS.get(name)({}, num_class=1, input_channels=16)
        assert type(head).__name__ == name and head.grid == 6
        return
    if name == "PointRCNNHead":
        from test_pointrcnn import pointrcnn_cfg

        head = ROI_HEADS.get(name)(dict(pointrcnn_cfg()["ROI_HEAD"]), num_class=1,
                                   input_channels=16)
        assert type(head).__name__ == name and head.num_points == 64
        return
    with pytest.raises(NotImplementedError, match=name):
        ROI_HEADS.get(name)({}, num_class=1)
