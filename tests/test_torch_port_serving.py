"""The port's serving artifact (``com_tpu_torch/utils/serving.py``), its
export and serve CLIs and ``utils/profiling.py``, on the CPU with
``configs/synthetic_models/centerpoint_synth_com.yaml`` at N = 2,048 (as
``tests/test_serving_export.py`` and ``tests/test_batch_server.py`` run
the JAX package's).

* Round trip: export, write, load; the artifact equals the eager step
  exactly (the same ops in the same order on the same device).  The
  loaded program holds none of export's metadata asserts, which change
  no output.
* Parity with JAX: ``com_tpu``'s StableHLO artifact (``platforms=("cpu",)``)
  and the port's ``.pt2``, from the same seeded, perturbed weights (no
  batch norm the identity; the size head's kernel shrunk 50-fold so that
  exp(dim) stays a box size, as the voxel eval comparison does), loaded and
  run on one numpy batch: boxes and scores within 1e-4, labels and valid
  equal.
* The anchor branch at the small KITTI grid of
  ``tests/test_torch_port_anchor_eval.py``, against its eager step.
* ``load_artifact`` in a fresh process imports neither the model code nor
  JAX; a voxel model's export raises by name; ``device=None`` without a
  card raises.
* The export CLI in process; the serve CLI over a real socket in a
  subprocess with ``--device cpu``: /health, /infer equal to the direct
  call, /stats counting it, a malformed body and a wrong ``X-Num-Feats``
  answered 400 (``tests/test_batch_server.py::test_http_server_roundtrip``).
* ``profiling``: ``StepTimer``'s averages; ``trace`` writes a Chrome trace.
"""
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.utils import serving as jax_serving
from com_tpu.utils.config import cfg_from_yaml_file as jax_cfg_from_yaml_file
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.tools import export
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.utils import profiling, serving
from com_tpu_torch.utils.config import cfg_from_yaml_file
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_anchor import (GRID, PC_RANGE, VSIZE, jax_variables, scene_batch,
                                    small_kitti_cfg)

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
SYNTH = "configs/synthetic_models/centerpoint_synth_com.yaml"
N = 2048
SPEC = {"points": ((2, N, 5), torch.float32), "points_mask": ((2, N), torch.bool)}


def _scene(rng, meta, n):
    lo, hi = np.array(meta.point_cloud_range[:3]), np.array(meta.point_cloud_range[3:])
    pts = np.zeros((n, 5), np.float32)
    pts[:, :3] = rng.uniform(lo, hi, (n, 3)) * 0.9
    pts[:, 3:] = rng.rand(n, 2)
    return pts


def _batch(meta, counts=(512, 300), seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((2, N, 5), np.float32)
    mask = np.zeros((2, N), bool)
    for i, n in enumerate(counts):
        pts[i, :n], mask[i, :n] = _scene(rng, meta, n), True
    return {"points": pts, "points_mask": mask}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synthetic config exported through the CLI on the CPU (seeded
    init), the eager model it came from and the artifact's stem."""
    stem = tmp_path_factory.mktemp("artifact") / "model"
    got_stem, manifest = export.main(["--cfg_file", SYNTH, "--output", str(stem),
                                      "--batch_size", "2", "--max_points", str(N),
                                      "--device", "cpu"])
    cfg = cfg_from_yaml_file(SYNTH)
    meta = export.export_meta(cfg)
    net = build_network(cfg.MODEL, meta, device="cpu")  # the CLI's seeded init
    return cfg, meta, net, got_stem, manifest


def test_export_cli_writes_the_artifact(synth):
    cfg, meta, _, stem, manifest = synth
    assert stem.with_suffix(".pt2").stat().st_size > 1e6
    assert json.loads(stem.with_suffix(".json").read_text()) == manifest
    jax_spec = {"points": jax.ShapeDtypeStruct((2, N, 5), jnp.float32),
                "points_mask": jax.ShapeDtypeStruct((2, N), jnp.bool_)}
    jcfg = jax_cfg_from_yaml_file(SYNTH)
    want = jax_serving.make_manifest(jcfg, meta, jax_spec, ("cpu",))
    assert manifest == want
    assert serving.batch_spec_from_manifest(manifest) == SPEC
    assert manifest["grid_size"] == [200, 200, 1]


def test_round_trip_equals_the_eager_step(synth):
    cfg, meta, net, stem, _ = synth
    run, manifest = serving.load_artifact(stem, device="cpu")
    assert manifest["platforms"] == ["cpu"]
    batch = _batch(meta)
    want = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device="cpu")(batch)
    got = run(batch)
    assert len(got) == 4 and int(got[3].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    for g, w in zip(run(tensors), want):
        assert torch.equal(g, w)


def _asserts(module):
    target = torch.ops.aten._assert_tensor_metadata.default
    return sum(n.target is target for m in module.modules()
               if isinstance(getattr(m, "graph", None), torch.fx.Graph) for n in m.graph.nodes)


def test_load_drops_the_metadata_asserts(synth):
    """The program as ``torch.export.load`` gives it guards each dtype cast
    with a host-side metadata assert; ``drop_metadata_asserts`` (what
    ``load_artifact`` runs) takes them all out, and the outputs stay."""
    _, meta, _, stem, _ = synth
    guarded = torch.export.load(stem.with_suffix(".pt2")).module()
    batch = [torch.from_numpy(v) for v in _batch(meta).values()]
    want = guarded(*batch)
    assert _asserts(guarded) > 10
    lean = serving.drop_metadata_asserts(guarded)
    assert lean is guarded and _asserts(lean) == 0
    for g, w in zip(lean(*batch), want):
        assert torch.equal(g, w)


def test_artifact_matches_the_jax_artifact(tmp_path):
    cfg = cfg_from_yaml_file(SYNTH)
    names = list(cfg.CLASS_NAMES)
    meta = export.export_meta(cfg)
    jmeta = JaxMeta(names, meta.point_cloud_range, meta.voxel_size, meta.grid_size, 5)
    batch = _batch(meta, seed=3)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), batch, train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=4)
    head = variables["params"]["CenterHead_0"]["head_0"]
    head["dim_out"]["kernel"] = head["dim_out"]["kernel"] * np.float32(0.02)
    jspec = {"points": jax.ShapeDtypeStruct((2, N, 5), jnp.float32),
             "points_mask": jax.ShapeDtypeStruct((2, N), jnp.bool_)}
    blob = jax_serving.export_eval_step(jnet, cfg.MODEL, names, jmeta, variables, jspec,
                                        platforms=("cpu",))
    jax_serving.write_artifact(tmp_path / "jax", blob,
                               jax_serving.make_manifest(cfg, jmeta, jspec, ("cpu",)))
    net = build_network(cfg.MODEL, meta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    program = serving.export_eval_step(net, cfg.MODEL, names, meta, SPEC, device="cpu")
    serving.write_artifact(tmp_path / "port", program,
                           serving.make_manifest(cfg, meta, SPEC, ["cpu"]))

    jrun, _ = jax_serving.load_artifact(tmp_path / "jax")
    prun, _ = serving.load_artifact(tmp_path / "port", device="cpu")
    want = [np.asarray(x) for x in jrun({k: jnp.asarray(v) for k, v in batch.items()})]
    got = [x.numpy() for x in prun(batch)]
    (gb, gs, gl, gv), (wb, ws, wl, wv) = got, want
    np.testing.assert_array_equal(gv, wv)
    assert gv.sum() > 20
    np.testing.assert_array_equal(gl[gv], wl[wv])
    np.testing.assert_allclose(gb[gv], wb[wv], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gs[gv], ws[wv], rtol=0, atol=1e-4)


def test_anchor_branch_round_trip(tmp_path):
    """KITTI PointPillars at a 64x64 grid (NMS_PRE_MAXSIZE 512), seeded
    perturbed weights carried from JAX, exported and loaded: equal to its
    eager step."""
    from com_tpu_torch.models.detectors import DatasetMeta

    cfg = small_kitti_cfg()
    names = list(cfg.CLASS_NAMES)
    host = scene_batch(np.random.RandomState(5))
    _, variables = jax_variables(cfg, JaxMeta(names, PC_RANGE, VSIZE, GRID, 4), host, seed=6)
    meta = DatasetMeta(names, PC_RANGE, VSIZE, GRID, 4)
    net = build_network(cfg.MODEL, meta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    spec = {"points": ((2, 8192, 4), torch.float32), "points_mask": ((2, 8192), torch.bool)}
    program = serving.export_eval_step(net, cfg.MODEL, names, meta, spec, device="cpu")
    serving.write_artifact(tmp_path / "kitti", program,
                           serving.make_manifest(cfg, meta, spec, ["cpu"]))
    run, manifest = serving.load_artifact(tmp_path / "kitti", device="cpu")
    assert manifest["model"] == cfg.MODEL["NAME"]
    want = make_eval_step(net, cfg.MODEL, names, meta, device="cpu")(host)
    got = run(host)
    assert int(got[3].sum()) > 20
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_load_artifact_imports_no_model_code(synth):
    stem = synth[3]
    code = (
        "import sys, numpy as np\n"
        "from com_tpu_torch.utils.serving import load_artifact\n"
        f"run, mf = load_artifact({str(stem)!r}, device='cpu')\n"
        "out = run({'points': np.zeros((2, %d, 5), np.float32),"
        " 'points_mask': np.zeros((2, %d), bool)})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'com_tpu')"
        " or m.startswith(('com_tpu_torch.models', 'com_tpu_torch.train'))]\n"
        "print(len(out), bad)\n" % (N, N))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "4 []"


@pytest.mark.parametrize("path", ["configs/kitti_models/second.yaml",
                                  "configs/waymo_models/com/centerpoint_voxel_comloss.yaml"])
def test_voxel_model_export_raises_by_name(path):
    cfg = cfg_from_yaml_file(path)
    with pytest.raises(NotImplementedError, match=f"{cfg.MODEL['NAME']} \\(MeanVFE\\)"):
        serving.export_eval_step(None, cfg.MODEL, list(cfg.CLASS_NAMES), None, SPEC,
                                 device="cpu")


def test_load_artifact_raises_without_a_card(synth):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_artifact(synth[3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(["--cfg_file", SYNTH, "--output", "unused"])


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.load(r)


def test_serve_cli_over_a_socket(synth):
    cfg, meta, _, stem, _ = synth
    proc = subprocess.Popen(
        [sys.executable, "-m", "com_tpu_torch.tools.serve", "--artifact", str(stem), "--port",
         "0", "--score_thresh", "0", "--max_wait_ms", "1", "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "http://" in line, line
        base = "http://" + line.split("http://", 1)[1].split()[0]
        deadline = time.time() + 120
        while True:
            try:
                if _get(base + "/health")[1]["ready"]:
                    break
            except urllib.error.URLError:
                pass
            assert proc.poll() is None and time.time() < deadline, "server never became ready"
            time.sleep(0.2)

        pts = _scene(np.random.RandomState(2), meta, 400)
        req = urllib.request.Request(base + "/infer", data=pts.tobytes(), method="POST",
                                     headers={"X-Num-Feats": "5"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.load(r)
        run, _ = serving.load_artifact(stem, device="cpu")
        direct = _batch(meta, counts=())
        direct["points"][0, :400], direct["points_mask"][0, :400] = pts, True
        boxes, scores, labels, valid = (t.numpy() for t in run(direct))
        np.testing.assert_array_equal(np.asarray(out["labels"]), labels[0][valid[0]])
        np.testing.assert_array_equal(np.asarray(out["boxes"], np.float32), boxes[0][valid[0]])
        np.testing.assert_array_equal(np.asarray(out["scores"], np.float32), scores[0][valid[0]])
        assert len(out["scores"]) > 0

        stats = _get(base + "/stats")[1]
        assert stats["requests"] == 2 and stats["batches"] == 2  # the warm-up and ours
        for body, headers in ((b"xyz", {}), (pts.tobytes(), {"X-Num-Feats": "4"})):
            bad = urllib.request.Request(base + "/infer", data=body, method="POST",
                                         headers=headers)
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(bad, timeout=10)
            assert err.value.code == 400 and "error" in json.load(err.value)
        assert _get(base + "/health")[0] == 200
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_step_timer_averages(monkeypatch):
    clock = iter([0.0, 1.0, 4.0, 4.5, 5.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()  # mark at 0
    timer.data_done()  # 1 s of data
    timer.step_done()  # 3 s of step
    timer.data_done()  # 0.5
    timer.step_done()  # 0.5
    assert timer.count == 2 and timer.avg_data == 0.75 and timer.avg_step == 1.75


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert prof.key_averages()
    stats = profiling.device_memory_stats()
    assert list(stats) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
