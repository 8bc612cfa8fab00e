"""Two-stage training under a data mesh: the port's Voxel-RCNN and
SECOND-IoU steps on two gloo ranks against ``com_tpu``'s step over a
2-device data mesh, on the CPU (``tests/torch_port_two_stage_setup.py``'s
narrowed configs and scenes, DP_RATIO 0, the RoI sampling random and fed
the uniforms the JAX step draws, each rank its scene's row).

Held: each rank's loss and terms to 1e-5 (the RoI losses' normalisers are
the whole batch's), its gradients after the reduction over the ranks to
the step tolerance (``test_torch_port_train_common.check_grads``) and the
norms' running statistics to 1e-5; the two ranks bitwise alike.  Then the
whole ``train_step`` with its own seeded generators, dropout 0.3 in a
third case, on the two ranks against one process over the global batch
(each rank draws its rows of the global draw: the same RoIs, the same
dropped units), loss and terms 1e-5, gradients at the step tolerance; a
one-rank group bitwise the single process.  The point-head losses
(``point_head_box_loss``, ``point_part_loss``, ``point_head_loss``) split
over the ranks equal the single-process loss on the whole batch to 1e-6.
One spawn of two ranks for the file (``torch_port_two_stage_mesh_worker``).
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
import torch_port_two_stage_mesh_worker as worker
from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.roi_heads.second_head import second_iou_loss as jax_second_iou_loss
from com_tpu.parallel.mesh import make_mesh as jax_make_mesh
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.parallel.launch import run_ranks
from com_tpu_torch.utils.config import CfgNode
from com_tpu_torch.utils.jax_weights import params_from_jax, state_dict_from_jax
from test_torch_port_parallel import load_rank
from test_torch_port_two_stage_train import jax_roi_uniforms
from torch_port_two_stage_setup import setup, small_cfg

torch.set_num_threads(2)
JAX_CASES = {"voxel_rcnn": 31, "second_iou": 32}  # seeds with foreground RoIs


def jax_mesh_case(which, seed, mesh):
    """The JAX loss, terms, gradients and statistics over ``mesh``, and the
    port's spec of the case (its config, start weights, batch, uniforms)."""
    cfg, jmeta, pmeta, jnet, variables, net, host = setup(which, seed)
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)
    key = jax.random.PRNGKey(seed)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"], rngs={"roi_sampling": key})
        loss, _, _, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        if "rcnn_cls" in out:
            roi_loss, roi_tb = jax_compute_roi_loss(out, cfg.MODEL)
            tb.update(roi_tb)
        else:
            roi_loss = tb["rcnn_loss_iou"] = jax_second_iou_loss(out,
                                                                 cfg.MODEL.ROI_HEAD.LOSS_CONFIG)
        return loss + roi_loss, (mut["batch_stats"], tb, out["roi_targets"].reg_valid)

    (jloss, (jbs, jtb, jfg)), jgrads = common.jax_value_and_grad(loss_fn, variables, host, mesh)
    p = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    spec = dict(cfg=CfgNode(cfg), meta=pmeta, start=net.state_dict(), batch=host,
                u=jax_roi_uniforms(key, 2, p).astype(np.float32))
    want = dict(jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
                jax_fg=np.asarray(jfg), jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
                jax_stats={k: v for k, v in state_dict_from_jax(
                    {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL,
                    names).items() if "running" in k})
    return spec, want


def dropout_case(host_spec):
    """Voxel-RCNN with DP_RATIO 0.3 from seeded weights (class bias +4, box
    kernel x0.02, as the train test's seeded step), on the first case's batch."""
    cfg = small_cfg("voxel_rcnn", dp_ratio=0.3)
    net = build_network(cfg.MODEL, host_spec["meta"], device="cpu", seed=3)
    with torch.no_grad():
        net.dense_head.conv_cls.bias.add_(4.0)
        net.dense_head.conv_box.weight.mul_(0.02)
    return dict(host_spec, cfg=CfgNode(cfg), start=net.state_dict())


def point_batch(rng, b=2, n=300, m=6):
    """Points, GT boxes and point-head predictions for the three losses."""
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :4, :3] = rng.uniform(-4, 4, (b, 4, 3))
    gt[:, :4, 3:6] = rng.uniform(1.5, 3.0, (b, 4, 3))
    gt[:, :4, 6] = rng.uniform(-np.pi, np.pi, (b, 4))
    gt[:, :4, 7] = rng.randint(1, 4, (b, 4))
    pts = rng.uniform(-5, 5, (b, n, 3)).astype(np.float32)
    pts[:, :60] = gt[:, :3, None, :3].repeat(20, 2).reshape(b, 60, 3) + rng.uniform(
        -0.5, 0.5, (b, 60, 3))
    return {"point_coords": pts.astype(np.float32), "gt_boxes": gt,
            "point_valid": rng.rand(b, n) > 0.1,
            "point_cls_preds": rng.randn(b, n, 3).astype(np.float32),
            "point_box_preds_raw": rng.randn(b, n, 8).astype(np.float32),
            "point_cls_scores_raw": rng.randn(b, n).astype(np.float32),
            "point_part_logits": rng.randn(b, n, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_stage_mesh")
    mesh = jax_make_mesh(jax.devices()[:2])
    cases, jax_runs = {}, {}
    for which, seed in JAX_CASES.items():
        cases[which], jax_runs[which] = jax_mesh_case(which, seed, mesh)
    cases["voxel_rcnn_dropout"] = dropout_case(cases["voxel_rcnn"])
    points = point_batch(np.random.RandomState(8))
    torch.save({"cases": cases, "points": points}, tmp / "spec.pt")
    run_ranks(worker.mesh_worker, 2, args=(str(tmp / "spec.pt"), str(tmp)), device="cpu",
              threads=1, init_dir=tmp)
    torch.set_num_threads(2)
    single = {name: worker.run_case(case) for name, case in cases.items()}
    return dict(jax=jax_runs, single=single, cases=cases,
                single_points=worker.point_losses({k: torch.from_numpy(v)
                                                   for k, v in points.items()}),
                ranks=[{c: load_rank(tmp / f"rank{r}_{c}.npz") for c in [*cases, "points"]}
                       for r in range(2)],
                world1=load_rank(tmp / "world1.npz")["same"])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("which", list(JAX_CASES))
def test_rank_matches_jax_mesh(runs, which, rank):
    """Loss and terms, gradients after the reduction, running statistics."""
    p = runs["ranks"][rank][which]
    r = dict(runs["jax"][which], loss=float(p["loss"]),
             tb={k: float(v) for k, v in p["tb"].items()}, metrics={"loss": p["loss"]},
             grads=p["grads"], stats=p["stats"])
    assert r["jax_fg"].sum() > 0
    assert "rcnn_loss_corner" in r["tb"] if which == "voxel_rcnn" else "rcnn_loss_iou" in r["tb"]
    common.check_loss_and_tb(r)
    common.check_grads(r)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("which", [*JAX_CASES, "voxel_rcnn_dropout"])
def test_ranks_train_step_matches_one_process(runs, which):
    """The whole step with the seeded RoI sampling and dropout on two ranks
    equals one process over the global batch; the ranks agree bitwise."""
    one = runs["single"][which]
    a, b = (runs["ranks"][r][which] for r in range(2))
    for key in ("step_loss", "step_tb", "step_grads"):
        for k, v in (a[key].items() if isinstance(a[key], dict) else [("", a[key])]):
            np.testing.assert_array_equal(b[key][k] if k else b[key], v, err_msg=f"{key}/{k}")
    assert abs(float(a["step_loss"]) - float(one["step_loss"])) <= 1e-5 * abs(float(one["step_loss"]))
    for k, v in one["step_tb"].items():
        assert abs(float(a["step_tb"][k]) - float(v)) <= 1e-5 * max(abs(float(v)), 1e-6), k
    assert float(one["step_tb"].get("rcnn_loss_reg", 1.0)) > 0
    common.check_grads(dict(grads=a["step_grads"], jax_grads=one["step_grads"]))


def test_one_rank_group_is_the_single_process_bitwise(runs):
    same = runs["world1"]
    assert same and all(bool(v) for v in same.values()), [k for k, v in same.items() if not v]


def test_point_head_losses_split_over_ranks(runs):
    for k, want in runs["single_points"].items():
        for r in range(2):
            got = float(runs["ranks"][r]["points"][k])
            assert abs(got - float(want)) <= 1e-6 * max(abs(float(want)), 1.0), (k, r)
        assert float(want) > 0


# ---- pcdet-layout state dicts through both loaders ----

def pcdet_pool(sd, rng):
    """``sd`` with the port's folded Voxel-RCNN pool replaced by pcdet's
    layers: mlps_in / mlps_pos (Conv1d (O, I, 1)) each with a norm of seeded
    statistics (eps 1e-5), and mlps_out + norm carrying the port's out and
    out_bn (the running variance moved to eps 1e-5)."""
    out = {k: v for k, v in sd.items() if ".roi_grid_pool_layers." not in k}
    i = 0
    while f"roi_head.roi_grid_pool_layers.{i}.pre.weight" in sd:
        t = f"roi_head.roi_grid_pool_layers.{i}"
        mid, width = sd[f"{t}.pre.weight"].shape
        for name, cin in (("mlps_in", width - 3), ("mlps_pos", 3)):
            out[f"{t}.{name}.0.0.weight"] = (rng.randn(mid, cin, 1) / np.sqrt(cin)).astype(
                np.float32)
            out[f"{t}.{name}.0.1.weight"] = rng.uniform(0.8, 1.2, mid).astype(np.float32)
            out[f"{t}.{name}.0.1.bias"] = (0.1 * rng.randn(mid)).astype(np.float32)
            out[f"{t}.{name}.0.1.running_mean"] = (0.1 * rng.randn(mid)).astype(np.float32)
            out[f"{t}.{name}.0.1.running_var"] = rng.uniform(0.5, 1.5, mid).astype(np.float32)
        out[f"{t}.mlps_out.0.0.weight"] = sd[f"{t}.out.weight"][..., None]
        for k in ("weight", "bias", "running_mean"):
            out[f"{t}.mlps_out.0.1.{k}"] = sd[f"{t}.out_bn.{k}"]
        out[f"{t}.mlps_out.0.1.running_var"] = sd[f"{t}.out_bn.running_var"] + (1e-3 - 1e-5)
        i += 1
    return out


def test_voxel_rcnn_pcdet_pool_folds_as_com_tpu(tmp_path, caplog):
    """A pcdet-layout Voxel-RCNN state dict through ``com_tpu``'s
    ``import_torch_state_dict`` and the port's ``load_params_only``: the
    port folds the pool (the keys it folded logged), and the eval steps'
    detections agree to 1e-4."""
    import copy
    import logging

    from com_tpu.utils.torch_import import import_torch_state_dict
    from com_tpu_torch.utils.checkpoint import load_params_only
    from test_torch_port_two_stage_model import check_eval

    cfg, jmeta, pmeta, jnet, variables, net, host = setup("voxel_rcnn", seed=21)
    sd = pcdet_pool({k: v.numpy() for k, v in net.state_dict().items()},
                    np.random.RandomState(3))
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["mismatch"] and not report["missing"] and not report["unused"], report
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "pcdet.pth")
    fresh = build_network(cfg.MODEL, pmeta, device="cpu", seed=9)
    before = copy.deepcopy(fresh.state_dict())
    with caplog.at_level(logging.INFO, logger="test_pcdet_pool"):
        loaded, skipped = load_params_only(tmp_path / "pcdet.pth", fresh,
                                           logging.getLogger("test_pcdet_pool"))
    records = [r.getMessage() for r in caplog.records]
    # every key (the pool's from the fold) but the pool norms' batch counters
    assert skipped == 0 and loaded == len([k for k in before
                                           if not k.endswith("out_bn.num_batches_tracked")])
    assert any("mlps_pos.0.1.running_var" in r for r in records)
    pre = fresh.roi_head.roi_grid_pool_layers[0].pre.weight
    assert not torch.equal(pre, before["roi_head.roi_grid_pool_layers.0.pre.weight"])
    check_eval(cfg, jmeta, pmeta, jnet, new_vars, fresh, host)


def test_pv_rcnn_shared_fc_columns_read_alike(tmp_path):
    """Kept alike (ROADMAP Queue 3): both packages flatten PV-RCNN's pooled
    grid grid-point-major and neither importer permutes pcdet's
    ``shared_fc_layer.0`` columns, so a pcdet-layout state dict (a seeded
    first shared layer) gives the same detections through both loaders."""
    from com_tpu.utils.torch_import import import_torch_state_dict
    from com_tpu_torch.utils.checkpoint import load_params_only
    from test_torch_port_two_stage_model import check_eval
    from torch_port_pvrcnn_setup import setup as pvrcnn_setup

    cfg, jmeta, pmeta, jnet, variables, net, host = pvrcnn_setup("pvrcnn", seed=41)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    w = sd["roi_head.shared_fc_layer.0.weight"]
    sd["roi_head.shared_fc_layer.0.weight"] = (np.random.RandomState(4).randn(*w.shape)
                                               * np.abs(w).mean()).astype(np.float32)
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["mismatch"] and not report["missing"] and not report["unused"], report
    torch.save({"model_state": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "pcdet.pth")
    load_params_only(tmp_path / "pcdet.pth", net)
    np.testing.assert_array_equal(net.roi_head.shared_fc_layer[0].weight.detach().numpy(),
                                  sd["roi_head.shared_fc_layer.0.weight"])
    check_eval(cfg, jmeta, pmeta, jnet, new_vars, net, host, min_valid=8)


def test_rank_code_imports_no_jax():
    """Spawn imports the ranks' module afresh in each child: it imports
    neither JAX nor the JAX package (``test_torch_port_slice``'s guard)."""
    from pathlib import Path

    from test_torch_port_slice import _FORBIDDEN

    text = (Path(__file__).parent / "torch_port_two_stage_mesh_worker.py").read_text()
    assert not _FORBIDDEN.search(text)
