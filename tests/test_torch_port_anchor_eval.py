"""The port's anchor post-processing and anchor eval step against the JAX
package on the CPU: class-agnostic and per-class NMS, NMS past 1,024
candidates (the row-blocked self-IoU) and on tied scores, and the KITTI
PointPillars eval step at a 64x64 grid with the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.models.dense_heads.anchor_head import anchor_post_process as jax_post_process
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.ops import nms as jnms
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu_torch.models.dense_heads.anchor_head import anchor_post_process
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops import nms as pnms
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_anchor import (ATOL, GRID, PC_RANGE, VSIZE, jax_variables, scene_batch,
                                    small_kitti_cfg, t)

torch.set_num_threads(2)


# post-processing

def _overlap_boxes():
    """tests/test_anchor_postprocess_cfg.py's case: two same-class
    overlapping boxes, one other-class box at the same spot, one far away."""
    b = np.zeros((1, 4, 7), np.float32)
    b[0, 0] = [0, 0, 0, 2, 2, 2, 0]
    b[0, 1] = [0.1, 0, 0, 2, 2, 2, 0]
    b[0, 2] = [0.1, 0.05, 0, 2, 2, 2, 0]
    b[0, 3] = [10, 10, 0, 2, 2, 2, 0]
    return b, np.asarray([[0.9, 0.8, 0.7, 0.6]], np.float32), np.asarray([[1, 1, 2, 1]],
                                                                         np.int32)


def _post_both(boxes, scores, labels, cfg, score_thresh=0.1, num_classes=None):
    got = [x.numpy() for x in anchor_post_process(t(boxes), t(scores), t(labels), cfg,
                                                  score_thresh, num_classes)]
    want = [np.asarray(x) for x in jax_post_process(jnp.asarray(boxes), jnp.asarray(scores),
                                                     jnp.asarray(labels), cfg, score_thresh,
                                                     num_classes)]
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g[got[3]], w[want[3]])
    return got


@pytest.mark.parametrize("multi,kept", [(False, [1, 1]), (True, [1, 1, 2])])
def test_post_process_class_agnostic_and_per_class(multi, kept):
    b, s, lb = _overlap_boxes()
    cfg = {"NMS_THRESH": 0.5, "NMS_PRE_MAXSIZE": 4, "NMS_POST_MAXSIZE": 4,
           "MULTI_CLASSES_NMS": multi}
    _, _, labels, valid = _post_both(b, s, lb, cfg, num_classes=2)
    assert sorted(labels[0][valid[0]].tolist()) == kept


def _crowd(rng, b, k, tie=False):
    """k candidate boxes a sample over a 40 x 40 m patch, many overlapping."""
    boxes = np.concatenate([rng.uniform(0, 40, (b, k, 2)), rng.uniform(-1, 1, (b, k, 1)),
                            rng.uniform(0.5, 4.5, (b, k, 2)), rng.uniform(1, 2, (b, k, 1)),
                            rng.uniform(-np.pi, np.pi, (b, k, 1))], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    if tie:  # a few score levels only: ties everywhere
        scores = np.round(scores * 8) / 8
    labels = rng.randint(1, 4, (b, k)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("k,tie", [(1536, False), (300, True)])
def test_nms_matches_jax_past_the_row_blocks_and_on_ties(k, tie):
    """K = 1,536 takes the row-blocked self-IoU (3 blocks of 512 rows);
    the tied case has few score levels.  nms_bev and multi_class_nms_bev
    select the same candidates with the same validity as the JAX package."""
    boxes, scores, labels = _crowd(np.random.RandomState(k), 1, k, tie)
    valid = scores > 0.2
    post = 600
    args = [jnp.asarray(x[0]) for x in (boxes, scores, labels, valid)]
    want = jnms.nms_bev(args[0], args[1], args[3], 0.1, post)
    wantm = jnms.multi_class_nms_bev(*args, 3, 0.1, post)
    got = pnms.nms_bev(t(boxes), t(scores), t(valid), 0.1, post)
    gotm = pnms.multi_class_nms_bev(t(boxes), t(scores), t(labels), t(valid), 3, 0.1, post)
    for (sel, sv), (wsel, wsv) in ((got, want), (gotm, wantm)):
        np.testing.assert_array_equal(sv[0].numpy(), np.asarray(wsv))
        np.testing.assert_array_equal(sel[0].numpy()[sv[0].numpy()],
                                      np.asarray(wsel)[np.asarray(wsv)])
        assert 10 < int(sv.sum()) < post
    if k > 1024:  # a block's rows are the unblocked rows
        sb = t(boxes)
        np.testing.assert_array_equal(pnms._self_iou(sb)[:, 700:716].numpy(),
                                      pnms.boxes_iou_bev(sb[:, 700:716], sb).numpy())


def test_post_processing_reaches_the_anchor_eval_step(slice_setup):
    """MODEL.POST_PROCESSING (not DENSE_HEAD's) reaches the eval step: the
    output width is its NMS_POST_MAXSIZE, and MULTI_CLASSES_NMS runs."""
    cfg, _, pmeta, _, _, net, host, _ = slice_setup
    model_cfg = dict(cfg.MODEL)
    post = dict(model_cfg["POST_PROCESSING"])
    post["NMS_CONFIG"] = dict(post["NMS_CONFIG"], NMS_POST_MAXSIZE=37, MULTI_CLASSES_NMS=True)
    model_cfg["POST_PROCESSING"] = post
    out = make_eval_step(net, model_cfg, list(cfg.CLASS_NAMES), pmeta, device="cpu")(host)
    assert all(o.shape[:2] == (2, 37) for o in out)
    assert int(out[3].sum()) > 0



@pytest.fixture(scope="module")
def slice_setup():
    cfg = small_kitti_cfg()
    names = list(cfg.CLASS_NAMES)
    meta = JaxMeta(names, PC_RANGE, VSIZE, GRID, 4)
    host = scene_batch(np.random.RandomState(5))
    jnet, variables = jax_variables(cfg, meta, host, seed=6)
    jax_out = [np.asarray(o) for o in jax.jit(jax_make_eval_step(jnet, cfg.MODEL, names, meta))(
        variables, host)]
    pmeta = DatasetMeta(names, PC_RANGE, VSIZE, GRID, 4)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    return cfg, meta, pmeta, jnet, variables, net, host, jax_out


def test_anchor_eval_step_matches_jax(slice_setup):
    cfg, _, pmeta, jnet, variables, net, host, jax_out = slice_setup
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta, device="cpu")
    boxes, scores, labels, valid = (x.numpy() for x in step(host))
    jb, js, jlab, jv = jax_out
    assert boxes.shape == jb.shape == (2, 500, 7)
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 20
    np.testing.assert_allclose(boxes[valid], jb[jv], rtol=0, atol=ATOL)
    np.testing.assert_allclose(scores[valid], js[jv], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(labels[valid], jlab[jv])
    # the raw head outputs, in the flat anchor layout
    with torch.no_grad():
        mine = net({k: torch.from_numpy(v) for k, v in host.items()})
    ref = jnet.apply(variables, dict(host), train=False)
    for key in ("cls_preds_raw", "box_preds_raw", "dir_cls_preds_raw"):
        assert mine[key].shape == ref[key].shape == (2, 32, 32, {"cls_preds_raw": 18,
                                                                "box_preds_raw": 42,
                                                                "dir_cls_preds_raw": 12}[key])
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
