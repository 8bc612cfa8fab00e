"""The port's serving slice against the JAX package, end to end on the CPU.

The flagship CenterPoint-Pillar config at a 64x64 grid, batch 2, ~4k
presorted points per scene (``__graft_entry__._build``), f32 on both sides
(MIXED_PRECISION off).  The JAX weights are perturbed from a seed (BN
running statistics included, so no norm is the identity), carried into the
port by its weight bridge, and both ``make_eval_step``s run on the same
batch.  Also: the bridge both ways, the port's BatchServer, the entry
points' device rule, and the port's import hygiene.
"""
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.serving.server import BatchServer
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.utils.jax_weights import load_jax_variables, state_dict_from_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def perturb(variables, seed):
    """Seeded perturbation of every leaf: kernels and biases get noise, BN
    scale/bias/mean shift, BN variances scale in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if path[-1] == "var":
            return a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if path[-1] in ("scale",):
            return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        scale = 0.1 if path[-1] in ("bias", "mean") else 0.05 * (np.abs(a).mean() + 1e-3)
        return a + scale * rng.randn(*a.shape).astype(np.float32)

    return {coll: walk(tree, (coll,)) for coll, tree in variables.items()
            if coll in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def slice_setup():
    cfg, meta, _, batch = graft._build(batch_size=2, num_points=4096, grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    jnet = jax_build_network(cfg.MODEL, meta)
    host = {"points": np.array(batch["points"]), "points_mask": np.array(batch["points_mask"])}
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), host, train=False)
    variables = perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=1)
    names = list(cfg.CLASS_NAMES)
    jax_out = jax.jit(jax_make_eval_step(jnet, cfg.MODEL, names, meta))(variables, host)
    jax_out = [np.asarray(o) for o in jax_out]
    pmeta = DatasetMeta(meta.class_names, meta.point_cloud_range, meta.voxel_size,
                        meta.grid_size, meta.num_point_features)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    return cfg, meta, pmeta, jnet, variables, net, host, jax_out


def _match(port_rows, jax_rows):
    """Pair each port detection with the JAX detection nearest to it (max
    abs difference over [box, score, label]); scores that tie to f32
    rounding may come out of NMS in either order.  Returns the worst pair
    distance and whether the pairing is one-to-one."""
    d = np.abs(port_rows[:, None, :] - jax_rows[None, :, :]).max(-1)
    nearest = d.argmin(1)
    return d[np.arange(len(d)), nearest].max(), len(set(nearest)) == len(nearest)


def test_slice_matches_jax_eval_step(slice_setup):
    cfg, _, pmeta, jnet, variables, net, host, jax_out = slice_setup
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta, device="cpu")
    boxes, scores, labels, valid = (t.numpy() for t in step(host))
    jb, js, jl, jv = jax_out
    assert boxes.shape == jb.shape == (2, 500, 7)
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 10  # the comparison has real detections in it
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)

    # the raw head outputs, per branch
    pts = {k: torch.as_tensor(np.array(v)) for k, v in host.items()}
    with torch.no_grad():
        mine = net(pts)["pred_dicts"][0]
    ref = jnet.apply(variables, dict(host), train=False)["pred_dicts"][0]
    for name in ("center", "center_z", "dim", "rot", "hm"):
        np.testing.assert_allclose(mine[name].numpy(), np.asarray(ref[name]), atol=ATOL,
                                   rtol=0, err_msg=name)


def test_bridge_roundtrip_through_jax_importer(slice_setup):
    """port state_dict -> the JAX package's pcdet importer -> the same flax
    variables the bridge started from, and nothing left unmapped."""
    cfg, _, _, _, variables, net, _, _ = slice_setup
    new_vars, report = import_torch_state_dict(
        {k: v.numpy() for k, v in net.state_dict().items()}, variables, cfg.MODEL,
        list(cfg.CLASS_NAMES))
    assert not report["missing"] and not report["mismatch"] and not report["unused"], report
    assert len(report["loaded"]) == sum(
        1 for k in net.state_dict() if not k.endswith("num_batches_tracked"))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_bridge_covers_every_tensor(slice_setup):
    cfg, _, _, _, variables, net, _, _ = slice_setup
    sd = state_dict_from_jax(variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    own = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == own
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves


def test_batch_server_on_cpu(slice_setup):
    """Three single-scene requests through the port's BatchServer (batch 2:
    one full batch and one padded) give the eval step's detections."""
    cfg, _, pmeta, _, _, net, host, _ = slice_setup
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta, device="cpu")
    boxes, scores, _, valid = (t.numpy() for t in step(host))
    server = BatchServer(step, {"points": (host["points"].shape, "float32")},
                         max_wait_ms=2000.0, device="cpu")
    try:
        futs = [server.submit(host["points"][i % 2]) for i in range(3)]
        res = [f.result(timeout=120) for f in futs]
    finally:
        server.close()
    assert server.stats.batches == 2 and server.stats.scenes_padded == 1
    for i, r in enumerate(res):
        keep = valid[i % 2] & (scores[i % 2] >= 0.1)
        assert np.isfinite(r["boxes"]).all() and (r["scores"] >= 0.1).all()
        np.testing.assert_allclose(r["boxes"], boxes[i % 2][keep], atol=1e-5)


def test_entry_points_need_a_device(monkeypatch, slice_setup):
    cfg, _, pmeta, _, _, net, _, _ = slice_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_network(cfg.MODEL, pmeta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchServer(lambda b: b, {"points": ((2, 16, 5), "float32")})


def test_config_loader_matches_jax():
    """The port's copy of the YAML loader gives the JAX package's tree for
    the flagship config, ``_BASE_CONFIG_`` and ``--set`` overrides included."""
    from com_tpu.utils import config as jax_config
    from com_tpu_torch.utils import config

    path = str(REPO / "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml")
    overrides = ["MODEL.MIXED_PRECISION", "False", "MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH",
                 "0.3", "DATA_CONFIG.DATA_PROCESSOR.0.REMOVE_OUTSIDE_BOXES", "False"]
    trees = []
    for mod in (jax_config, config):
        cfg = mod.cfg_from_yaml_file(path)
        mod.cfg_from_list(overrides, cfg)
        trees.append(cfg)
    assert trees[1] == trees[0]
    assert trees[1].MODEL.MIXED_PRECISION is False
    assert trees[1].DATA_CONFIG.POINT_CLOUD_RANGE  # from the _BASE_CONFIG_ file
    with pytest.raises(AssertionError, match="unknown config key"):
        config.cfg_from_list(["MODEL.NO_SUCH_KEY.X", "1"], trees[1])


# JAX, the JAX package, and the repository's top-level ``tools`` (its TPU
# sweeps and ``tools/perf/tpu_timeit.py``); the port's own tools are
# ``com_tpu_torch.tools``
_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|com_tpu|__graft_entry__|tools)\b"
                        r"|from\s+(jax|com_tpu|__graft_entry__|tools)\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "com_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    """The port and chip_smoke.py import neither JAX nor the JAX package,
    nor the repository's TPU tools."""
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.search(text), path


@pytest.mark.parametrize("line,forbidden", [
    ("import tools.perf.tpu_timeit", True),
    ("from tools.perf import microbench_wgrad_kernels", True),
    ("    from tools import train", True), ("import jax.numpy as jnp", True),
    ("from com_tpu.ops import conv2d", True),
    ("from com_tpu_torch.tools.perf import microbench_wgrad_kernels", False),
    ("import toolsmith", False), ("from .tools import x", False)])
def test_import_guard_pattern(line, forbidden):
    """The guard catches the JAX side and the top-level tools, and lets the
    port's own ``com_tpu_torch.tools`` through."""
    assert bool(_FORBIDDEN.search(line)) == forbidden
