"""The port's data parallelism beyond the CenterPoint step, on two gloo ranks
on the CPU (one spawn for the module, ``torch_port_parallel_worker.
loop_worker``), each against ``com_tpu`` over a 2-device data mesh or the
port's own single process:

* the KITTI PointPillars anchor step with its curriculum at the anchor
  tests' size (64x64 grid, 2 scenes, f32), rank r on scene r: loss and
  terms (the global ``/ b``), gradients, batch statistics, the anchor EMA,
  the (3, 96) sums and the parameters against JAX's step on the mesh;
* ``train_model`` over 2 mini-epochs of 2 steps (the tiny flagship at a
  32x32 grid): each epoch's feedback identical on both ranks and equal to
  the single process's, counts exact; checkpoints from rank 0 alone;
* ``eval_model`` over ``build_dataloader(dist=True)`` shards of 5 synthetic
  scenes (rank 1's shard padded by one): every rank's det_annos in dataset
  order equal to the single process's and to ``com_tpu``'s
  ``eval_model(mesh=...)``, the recall counts summed without the padding;
* ``build_dataloader(dist=True)``'s shards: ``com_tpu``'s, disjoint up to
  the padding, covering;
* the train and test CLIs with ``--multihost``: rank 0 alone writes, the
  global batch is two ranks' batches, the ranks' parameters agree bitwise
  and the data-parallel test CLI finds what the single-process one finds.
"""
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
import torch_port_parallel_worker as worker
from com_tpu.data.dataset import PrefetchLoader as JaxPrefetchLoader
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from com_tpu.losses.anchor_losses import AnchorCurriculumState as JaxAnchorState
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.parallel.mesh import make_mesh as jax_make_mesh
from com_tpu.train import eval as jax_eval
from com_tpu.train.optim import build_optimizer as jax_build_optimizer
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.utils import config as jax_config
from com_tpu_torch.data.dataset import build_dataloader
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.parallel.launch import run_ranks
from com_tpu_torch.train.eval import eval_model, make_eval_step
from com_tpu_torch.utils import config
from com_tpu_torch.utils.config import CfgNode
from com_tpu_torch.utils.jax_weights import (load_jax_variables, params_from_jax,
                                             state_dict_from_jax)
from test_torch_port_anchor import GRID as KITTI_GRID
from test_torch_port_anchor import PC_RANGE, VSIZE, jax_variables
from test_torch_port_anchor_train import (START_INIT, START_MEANS, START_STDS, anchor_cfg,
                                          train_batch)
from test_torch_port_cli import CFG as CLI_CFG
from test_torch_port_cli import SMALL as CLI_SMALL
from test_torch_port_eval import NAMES, _eval_cfg, eval_start
from test_torch_port_parallel import load_rank

torch.set_num_threads(2)

SHARD_CFG = {  # tests/test_multihost_sharding.py's ds_cfg(13)
    "DATASET": "SyntheticDataset", "NUM_SCENES": 13, "NUM_OBJECTS": 3, "NUM_BG_POINTS": 512,
    "POINT_CLOUD_RANGE": [-20, -20, -2, 20, 20, 4], "MAX_POINTS_PER_SCENE": 1024,
    "MAX_GT_OBJECTS": 8,
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z", "intensity", "elongation"],
        "src_feature_list": ["x", "y", "z", "intensity", "elongation"]},
    "DATA_PROCESSOR": []}


def anchor_case(mesh):
    """JAX's anchor step (curriculum on) over ``mesh`` and the ranks' spec."""
    cfg = anchor_cfg(True)
    names = list(cfg.CLASS_NAMES)
    meta = JaxMeta(names, PC_RANGE, VSIZE, KITTI_GRID, 4)
    host = train_batch(np.random.RandomState(8))
    jnet, variables = jax_variables(cfg, meta, host, seed=9)
    start = (np.asarray(START_MEANS, np.float32), np.asarray(START_STDS, np.float32),
             np.asarray(START_INIT))
    jcur = (JaxAnchorState(*(jnp.asarray(a) for a in start)),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, new_cur, aux, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, meta, jcur, 0)
        return loss, (mut["batch_stats"], new_cur, aux, tb)

    (jloss, (jbs, jnew, jaux, jtb)), jgrads = common.jax_value_and_grad(loss_fn, variables,
                                                                        host, mesh)
    tx, _ = jax_build_optimizer(variables["params"], cfg.OPTIMIZATION, worker.TOTAL_STEPS, 10)
    updates, _ = tx.update(jgrads, tx.init(variables["params"]), variables["params"])
    jparams = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), variables["params"], updates)
    want = dict(
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        jax_cur=jnew[0], jax_conf=(np.asarray(jaux[0].confidence_sum),
                                   np.asarray(jaux[0].confidence_cnt)),
        jax_params=params_from_jax(jparams, cfg.MODEL, names))
    pmeta = DatasetMeta(names, PC_RANGE, VSIZE, KITTI_GRID, 4)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    spec = dict(cfg=CfgNode(cfg), meta=pmeta, start=net.state_dict(),
                curriculum=("AnchorCurriculumState", start), fmap_hw=None, epoch=0, batch=host)
    return want, spec


def eval_case(mesh):
    """``com_tpu``'s ``eval_model(mesh=...)`` and the port's single process
    over 5 synthetic scenes (batch 2), and the ranks' spec (batch 1 a rank)."""
    jcfg, pcfg = _eval_cfg(jax_config), _eval_cfg(config)
    jcfg.DATA_CONFIG.NUM_SCENES = pcfg.DATA_CONFIG.NUM_SCENES = 5
    jds, jloader = jax_build_dataloader(jcfg.DATA_CONFIG, NAMES, 2, training=False, workers=1)
    jnet, variables, jmeta, pmeta = eval_start(jcfg, jds)
    jstep = jax_eval.make_eval_step(jnet, jcfg.MODEL, NAMES, jmeta)
    jax_annos, jax_recall, _ = jax_eval.eval_model(jstep, variables, jloader, NAMES, mesh=mesh)
    net = build_network(pcfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, pcfg.MODEL, NAMES)
    _, ploader = build_dataloader(pcfg.DATA_CONFIG, NAMES, 2, training=False, workers=1)
    single, single_recall, _ = eval_model(make_eval_step(net, pcfg.MODEL, NAMES, pmeta,
                                                         device="cpu"), ploader, NAMES)
    spec = dict(cfg=pcfg, meta=pmeta, start=net.state_dict(), batch_size=1)
    return dict(jax=(jax_annos, jax_recall), single=(single, single_recall)), spec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_loop")
    mesh = jax_make_mesh(jax.devices()[:2])
    anchor_want, anchor_spec = anchor_case(mesh)
    evals, eval_spec = eval_case(mesh)
    cli_head = ["--cfg_file", CLI_CFG, "--device", "cpu", "--workers", "1"]
    spec = dict(anchor=anchor_spec, loop=worker.tiny_case(), eval=eval_spec, shards=SHARD_CFG,
                cli=(cli_head, CLI_SMALL))
    torch.save(spec, tmp / "spec.pt")
    run_ranks(worker.loop_worker, 2, args=(str(tmp / "spec.pt"), str(tmp)), device="cpu",
              threads=1, init_dir=tmp)
    single_loop = worker.train_loop(spec["loop"], None, tmp / "single_ckpt")
    single_run, single_test = worker.cli_runs(cli_head, CLI_SMALL, tmp / "single_cli")
    ranks = []
    for r in range(2):
        with open(tmp / f"rank{r}_eval.pkl", "rb") as f:
            ev = pickle.load(f)
        with open(tmp / f"rank{r}_cli.pkl", "rb") as f:
            cli_test = pickle.load(f)
        ranks.append(dict(anchor=load_rank(tmp / f"rank{r}_anchor.npz"),
                          loop=load_rank(tmp / f"rank{r}_loop.npz"), eval=ev,
                          shards=load_rank(tmp / f"rank{r}_shards.npz"),
                          cli=load_rank(tmp / f"rank{r}_cli.npz"), cli_test=cli_test))
    return dict(tmp=tmp, anchor=anchor_want, evals=evals, ranks=ranks, single_loop=single_loop,
                single_run=single_run, single_test=single_test)


def anchor_result(runs, rank):
    p = runs["ranks"][rank]["anchor"]
    return dict(runs["anchor"], loss=float(p["loss"]),
                tb={k: float(v) for k, v in p["tb"].items()},
                metrics={"loss": p["metrics_loss"]}, grads=p["grads"], stats=p["stats"],
                cur=types.SimpleNamespace(**{k: torch.from_numpy(v)
                                             for k, v in p["cur"].items()}),
                conf=(p["conf_sum"], p["conf_cnt"]), params=p["params"])


@pytest.mark.parametrize("rank", [0, 1])
def test_anchor_rank_loss_matches_jax_mesh(runs, rank):
    r = anchor_result(runs, rank)
    assert set(r["tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir"}
    common.check_loss_and_tb(r)


@pytest.mark.parametrize("rank", [0, 1])
def test_anchor_rank_gradients_match_jax_mesh(runs, rank):
    common.check_grads(anchor_result(runs, rank))


@pytest.mark.parametrize("rank", [0, 1])
def test_anchor_rank_state_matches_jax_mesh(runs, rank):
    """Batch statistics, the AnchorCurriculumState, the (3, 96) sums
    (counts exact), as ``test_torch_port_anchor_train`` holds them."""
    r = anchor_result(runs, rank)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    for f in r["jax_cur"]._fields:
        np.testing.assert_allclose(getattr(r["cur"], f).numpy(),
                                   np.asarray(getattr(r["jax_cur"], f)), rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    js, jc = r["jax_conf"]
    assert jc.sum() > 0
    np.testing.assert_array_equal(r["conf"][1], jc)
    np.testing.assert_allclose(r["conf"][0], js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rank", [0, 1])
def test_anchor_rank_parameters_match_jax_mesh(runs, rank):
    common.check_params_after_step(anchor_result(runs, rank))


def test_train_model_feedback_is_the_same_on_every_rank(runs):
    a, b = (runs["ranks"][r]["loop"] for r in range(2))
    assert a["received"].shape == (2, 3, 96) and a["conf_cnt"].sum() > 0
    np.testing.assert_array_equal(a["received"], b["received"])
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


def test_train_model_feedback_matches_the_single_process(runs):
    """Each epoch's confidences are the all-reduced sums, as one process
    over the whole batches computes them (counts exact)."""
    a, single = runs["ranks"][0]["loop"], runs["single_loop"]
    np.testing.assert_array_equal(a["conf_cnt"], single["conf_cnt"])
    np.testing.assert_allclose(a["conf_sum"], single["conf_sum"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["received"], single["received"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["losses"], single["losses"], rtol=1e-4)


def test_train_model_checkpoints_on_rank_zero_only(runs):
    tmp = runs["tmp"]
    assert sorted(p.name for p in (tmp / "ckpt0").iterdir()) == [
        "checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth"]
    assert not (tmp / "ckpt1").exists()


def check_annos(got, want):
    assert [g["frame_id"] for g in got] == [w["frame_id"] for w in want]
    for g, w in zip(got, want):
        assert len(g["score"]) == len(w["score"])
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g["boxes_lidar"], w["boxes_lidar"], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rank", [0, 1])
def test_eval_model_mesh_matches_single_process(runs, rank):
    got, recall = runs["ranks"][rank]["eval"]
    want, want_recall = runs["evals"]["single"]
    assert len(got) == 5 and sum(len(a["score"]) for a in got) > 0
    check_annos(got, want)
    assert recall == want_recall and want_recall["gt"] > 0


def test_eval_model_mesh_matches_jax_mesh(runs):
    got, recall = runs["ranks"][0]["eval"]
    want, want_recall = runs["evals"]["jax"]
    check_annos(got, want)
    assert recall == want_recall


def test_dist_loader_shards_match_jax(runs):
    ds = JaxSyntheticDataset(jax_config.CfgNode(SHARD_CFG), ["Vehicle"], training=True)
    for r in range(2):
        got = runs["ranks"][r]["shards"]
        assert (int(got["index"]), int(got["count"])) == (r, 2)
        for epoch in (0, 1):
            loader = JaxPrefetchLoader(ds, batch_size=1, shuffle=True, seed=4, num_workers=1,
                                       process_index=r, process_count=2)
            loader.set_epoch(epoch)
            np.testing.assert_array_equal(got[f"epoch{epoch}"], loader._shard_order())


def test_dist_loader_shards_cover_the_dataset(runs):
    a, b = (runs["ranks"][r]["shards"] for r in range(2))
    assert len(a["frames"]) == len(b["frames"]) == 7
    both = np.concatenate([a["epoch0"], b["epoch0"]])
    assert set(both.tolist()) == set(range(13)) and len(both) == 14  # one wrapped duplicate
    assert len(set(a["frames"]) | set(b["frames"])) == 13


def test_cli_multihost_runs_data_parallel(runs):
    """Two ranks of one global batch of 2: rank 0 alone logs, writes metrics
    and its checkpoint; the ranks' parameters agree bitwise."""
    a, b = (runs["ranks"][r]["cli"] for r in range(2))
    assert [int(a["rank"]), int(b["rank"])] == [0, 1] and int(a["world"]) == 2
    assert int(a["global_batch"]) == 2 * runs["single_run"]["global_batch"]
    assert int(a["iterations"]) == int(b["iterations"]) == runs["single_run"]["iterations"] // 2
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    out = next((runs["tmp"] / "cli").rglob("ckpt")).parent
    assert [p.name for p in (out / "ckpt").iterdir()] == ["checkpoint_epoch_1.pth"]
    assert len(list(out.glob("log_train_*.txt"))) == 1
    assert (out / "metrics" / "metrics.jsonl").exists()
    assert len(list((out / "eval").rglob("result.pkl"))) == 1


def test_cli_multihost_eval_matches_the_single_process(runs):
    """The test CLI over two shards of the checkpoint the two ranks wrote
    finds, on every rank, what one process finds on it."""
    from com_tpu_torch.tools import test

    ckpt = next((runs["tmp"] / "cli").rglob("checkpoint_epoch_1.pth"))
    flags = ["--cfg_file", CLI_CFG, "--device", "cpu", "--workers", "1", "--output_dir",
             str(runs["tmp"] / "single_eval"), "--ckpt", str(ckpt), "--set", *CLI_SMALL]
    want = test.main(flags)[0]
    for r in range(2):
        annos, recalls = runs["ranks"][r]["cli_test"]
        check_annos(annos, want["det_annos"])
        assert recalls == want["recalls"]
