"""``com_tpu_torch.tools.perf.k1_path`` on the CPU: the f32 step it compares
is reproducible, the test's checks read as ratios to their tolerances (0
for a step against itself), and the K1 router leaves CPU calls to the plain
versions untouched (the routes act on the card only)."""
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
