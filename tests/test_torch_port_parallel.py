"""The port's data-parallel train step on two gloo ranks against
``com_tpu``'s step over a 2-device data mesh, on the CPU.

The flagship CenterPoint-Pillar COM config at the slice tests' size
(``test_torch_port_train_common``: 64x64 grid, 2 scenes of ~4k points, 16
object slots, f32, perturbed weights, the curriculum EMA away from zero),
with COM loss weighting off and on.  JAX runs its step on the whole batch
sharded over ``make_mesh(jax.devices()[:2])``; the port runs one process a
rank (``com_tpu_torch.parallel.launch.run_ranks``, spawned once for the
module, functions in ``torch_port_parallel_worker.py``), rank r on scene r.
Each rank's loss, gradients (after the reduction over ranks), batch
statistics, curriculum state, confidence sums (after the epoch-end
reduction; counts exact) and parameters after the optimizer are held to
the slice tests' tolerances (``check_*`` of the common module, unchanged);
the two ranks must agree bitwise.  Then the reduction's convention (the
mean of gradients that each carry the global loss) and a one-rank group,
which must leave the single-process step bitwise as it is.
"""
import types

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import test_torch_port_train_common as common
import torch_port_parallel_worker as worker
from com_tpu.parallel.mesh import make_mesh as jax_make_mesh
from com_tpu_torch.models.detectors import DatasetMeta
from com_tpu_torch.parallel.launch import run_ranks
from com_tpu_torch.utils.config import CfgNode

torch.set_num_threads(2)

CASES = ("plain", "ucl")


def port_case(j, meta, host, fmap_hw):
    """A spec entry for the ranks: the port's config, meta and start
    weights bridged from the JAX variables, the curriculum start, the batch."""
    cfg = CfgNode(j["cfg"])
    net, state, _ = common.port_start(j["cfg"], meta, j["variables"], j["jcur"])
    cur = state.curriculum[0]
    return dict(cfg=cfg, meta=DatasetMeta(list(meta.class_names), meta.point_cloud_range,
                                          meta.voxel_size, meta.grid_size,
                                          meta.num_point_features),
                start=net.state_dict(), curriculum=(type(cur).__name__, [t.numpy() for t in cur]),
                fmap_hw=fmap_hw, epoch=0, batch=host)


def load_rank(path):
    """A rank's npz as nested dicts (``group/key``)."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            group, _, key = k.partition("/")
            if key:
                out.setdefault(group, {})[key] = z[k]
            else:
                out[group] = z[k]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    mesh = jax_make_mesh(jax.devices()[:2])
    spec, jax_runs = {}, {}
    for case in CASES:
        cfg, meta, _, batch = graft._build(batch_size=2, num_points=4096, grid=common.GRID,
                                           num_max_objs=16)
        cfg.MODEL.MIXED_PRECISION = False
        cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = case == "ucl"
        host = {k: np.array(v) for k, v in batch.items()}
        jax_runs[case] = common.jax_step(cfg, meta, host, ("points", "points_mask"), mesh=mesh)
        spec[case] = port_case(jax_runs[case], meta, host, common.GRID[:2])
    torch.save(spec, tmp / "spec.pt")
    run_ranks(worker.steps_worker, 2, args=(str(tmp / "spec.pt"), str(tmp)), device="cpu",
              threads=1, init_dir=tmp)
    ranks = [{c: load_rank(tmp / f"rank{r}_{c}.npz") for c in CASES} for r in range(2)]
    world1 = {c: load_rank(tmp / f"world1_{c}.npz")["same"] for c in CASES}
    return dict(jax=jax_runs, ranks=ranks, world1=world1)


def result(runs, case, rank):
    """The common checks' dict: the JAX results beside one rank's."""
    p = runs["ranks"][rank][case]
    return dict(runs["jax"][case], loss=float(p["loss"]),
                tb={k: float(v) for k, v in p["tb"].items()},
                metrics={"loss": p["metrics_loss"]}, grads=p["grads"], stats=p["stats"],
                cur=types.SimpleNamespace(**{k: torch.from_numpy(v)
                                             for k, v in p["cur"].items()}),
                conf=(p["conf_sum"], p["conf_cnt"]), params=p["params"])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_rank_loss_matches_jax_mesh(runs, case, rank):
    common.check_loss_and_tb(result(runs, case, rank))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_rank_gradients_match_jax_mesh(runs, case, rank):
    common.check_grads(result(runs, case, rank))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_rank_state_matches_jax_mesh(runs, case, rank):
    """Batch statistics, curriculum EMA, confidence sums (counts exact)."""
    common.check_state(result(runs, case, rank))


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("case", CASES)
def test_rank_parameters_match_jax_mesh(runs, case, rank):
    common.check_params_after_step(result(runs, case, rank))


@pytest.mark.parametrize("case", CASES)
def test_ranks_agree_bitwise(runs, case):
    a, b = runs["ranks"][0][case], runs["ranks"][1][case]
    for key in ("loss", "metrics_loss", "conf_sum", "conf_cnt"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in ("tb", "grads", "stats", "cur", "params"):
        for k, v in a[key].items():
            np.testing.assert_array_equal(b[key][k], v, err_msg=f"{key}/{k}")


@pytest.mark.parametrize("case", CASES)
def test_gradient_reduction_is_the_mean(runs, case):
    """Every rank's loss is the global one, so each rank's own gradient
    carries the global loss's factor: the reduction is the mean (a sum
    would double every gradient), and no rank's own gradient is already
    the reduced one."""
    a, b = runs["ranks"][0][case], runs["ranks"][1][case]
    for k, g in a["grads"].items():
        np.testing.assert_array_equal(g, (a["local"][k] + b["local"][k]) / 2, err_msg=k)
    biggest = max(a["grads"], key=lambda k: np.abs(a["grads"][k]).max())
    assert not np.allclose(a["local"][biggest], a["grads"][biggest], rtol=1e-3)
    common.check_grads(dict(result(runs, case, 0), grads=a["grads"]))


@pytest.mark.parametrize("case", CASES)
def test_one_rank_group_is_the_single_process_step(runs, case):
    """Over a one-rank group every collective is the identity: the loss,
    terms, gradients, statistics, curriculum, sums and parameters are
    bitwise those of the step without a mesh."""
    same = runs["world1"][case]
    assert len(same) > 10
    assert all(bool(v) for v in same.values()), [k for k, v in same.items() if not v]


def test_rank_code_imports_no_jax():
    """Spawn imports the ranks' module afresh in each child: it imports
    neither JAX nor the JAX package (the guard of ``test_torch_port_slice``)."""
    from pathlib import Path

    from test_torch_port_slice import _FORBIDDEN

    text = (Path(__file__).parent / "torch_port_parallel_worker.py").read_text()
    assert not _FORBIDDEN.search(text)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A rank's exception is raised again in the parent, and the rank
    waiting for it in a collective is ended: no rank is skipped."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 fails"):
        run_ranks(worker.failing_rank, 2, device="cpu", threads=1, init_dir=tmp_path,
                  timeout_s=60)
