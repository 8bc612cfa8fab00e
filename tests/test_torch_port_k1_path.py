"""``com_tpu_torch.tools.perf.k1_path`` on the CPU: the f32 step it compares
is reproducible, the test's checks read as ratios to their tolerances (0
for a step against itself), the K1 router leaves CPU calls to the plain
versions untouched (the routes act on the card only), and the kink recorder
finds nothing to count or impose in a step against itself."""
from com_tpu_torch.tools.perf import k1_path


def test_k1_path_step_ratios_and_router():
    step = k1_path.step_grads("cpu", shift=False)
    ratios = k1_path.ratios(step, step)
    assert "loss" in ratios and any(k.endswith("running_var") for k in ratios)
    assert max(ratios.values()) == 0.0
    with k1_path.K1Router(plain_fwd=True, plain_bwd=True) as router:
        again = k1_path.step_grads("cpu", shift=False)
    assert k1_path._fingerprint(again) == k1_path._fingerprint(step)
    assert router.worst == {}
    moved = k1_path.step_grads("cpu", shift=True)
    assert k1_path._fingerprint(moved) != k1_path._fingerprint(step)


def test_kink_recorder_against_itself():
    """Recording a step's ReLU inputs and tied maxima leaves the step as it
    was; counted against the same step nothing flips and no tied set
    differs, and imposing its own decisions gives the same step bit for
    bit."""
    plain = k1_path.step_grads("cpu", shift=False)
    with k1_path.KinkRecorder() as ref:
        recorded = k1_path.step_grads("cpu", shift=False, on_net=ref.on_net)
    assert k1_path._fingerprint(recorded) == k1_path._fingerprint(plain)
    assert len(ref.relu) == 27 and len(ref.ties) == 2  # 27 ReLUs, K1's max and the canvas max
    with k1_path.KinkRecorder(ref, ("relu", "max")) as rec:
        imposed = k1_path.step_grads("cpu", shift=False, on_net=rec.on_net)
    assert k1_path._fingerprint(imposed) == k1_path._fingerprint(plain)
    assert len(rec.report) == 29
    assert all(" 0 of " in line or " 0 (run" in line or ": 0 source" in line
               for line in rec.report), rec.report
    assert any(line.startswith("relu backbone_2d.deblocks.2.2 ") for line in rec.report)
