"""The kernels' registered ops (``torch.library.custom_op``, namespace
``com_tpu_torch``) on the CPU.

* ``torch.library.opcheck`` on each op at small ragged shapes: the schema,
  the fake implementation against the real one, the autograd registration
  and a trace through AOT dispatch with dynamic shapes.  K1's forward and
  K2 also with inputs that require grad (their ``register_autograd``).
* On CPU tensors each op is its plain version, bit for bit, and launches
  nothing.
* ``torch.autograd.gradcheck`` in f64 through K1 sum and max (the max on
  distinct values and on tied maxima) and through K2's registered autograd
  (x and w): the plain versions reduce in f64 for f64 input.
* On meta tensors each op reaches its fake implementation, which gives
  shapes and dtypes and never asks ``_kernels`` for a library.
* ``torch.export`` keeps each op as one node of the graph, which the
  loaded program calls.
"""
import numpy as np
import pytest
import torch

from com_tpu_torch.ops import _kernels, conv2d, nms, seg_scan

OPS = torch.ops.com_tpu_torch
SEG = torch.tensor([[0, 0, 1, 1, 1, 2, 5, 5, 7], [3, 3, 3, 3, 4, 4, 9, 9, 9]],
                   dtype=torch.int32)


def _cases(dtype=torch.float32, grad=False):
    """(name, op, args, plain result) at small ragged shapes."""
    g = torch.Generator().manual_seed(0)
    vals = torch.randn(2, 9, 3, dtype=dtype, generator=g)
    out = seg_scan.run_bcast_plain(vals, SEG, "max")
    gy = torch.randn(2, 9, 3, dtype=dtype, generator=g)
    x = torch.randn(2, 5, 6, 3, dtype=dtype, generator=g)
    w = torch.randn(3, 3, 3, 4, dtype=dtype, generator=g)
    gx = torch.randn(2, 5, 6, 4, dtype=dtype, generator=g)
    over = torch.rand(2, 7, 7, generator=g) > 0.6
    valid = torch.rand(2, 7, generator=g) > 0.2

    def req(t):
        return t.clone().requires_grad_(grad)

    return [
        ("k1_sum", OPS.run_bcast, (req(vals), SEG, "sum"),
         seg_scan.run_bcast_plain(vals, SEG, "sum")),
        ("k1_max", OPS.run_bcast, (req(vals), SEG, "max"), out),
        ("k1_sum_bwd", OPS.run_bcast_bwd, (gy, SEG, None, None),
         seg_scan.run_bcast_plain(gy, SEG, "sum")),
        ("k1_max_bwd", OPS.run_bcast_bwd, (gy, SEG, vals, out),
         seg_scan.run_bcast_max_bwd_plain(gy, vals, out, SEG)),
        ("k2", OPS.conv3x3, (req(x), req(w), False), conv2d.conv3x3_plain(x, w)),
        ("k2_dgrad", OPS.conv3x3, (gx, w, True),
         conv2d.conv3x3_plain(gx, conv2d.rotate_kernel(w))),
        ("k2w", OPS.conv3x3_wgrad, (x, gx), conv2d.conv3x3_wgrad_plain(x, gx)),
        ("k4", OPS.greedy_suppress, (over, valid), nms.greedy_suppress_plain(over, valid)),
    ]


NAMES = [c[0] for c in _cases()]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", NAMES)
def test_opcheck(case, dtype, grad):
    name, op, args, _ = _cases(dtype, grad)[NAMES.index(case)]
    torch.library.opcheck(op.default, args)


@pytest.mark.parametrize("case", NAMES)
def test_cpu_op_is_the_plain_version(case):
    counters = [(seg_scan, "launches"), (seg_scan, "bwd_launches"), (conv2d, "launches"),
                (conv2d, "dgrad_launches"), (conv2d, "wgrad_launches"), (nms, "launches")]
    before = [getattr(m, a) for m, a in counters]
    _, op, args, want = _cases()[NAMES.index(case)]
    got = op(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert [getattr(m, a) for m, a in counters] == before


@pytest.mark.parametrize("values", ["distinct", "tied"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_run_bcast_gradcheck(op, values):
    """K1 in f64 through its registered autograd; with tied maxima the
    max's gradient is split over the ties (one-sided: perturbing one tied
    value breaks the tie), so the tied case checks the analytic split
    against the plain backward instead of finite differences."""
    rng = np.random.RandomState(1)
    v = torch.from_numpy(rng.randn(2, 9, 3)).requires_grad_()
    if values == "distinct":
        assert torch.autograd.gradcheck(lambda t: seg_scan.run_bcast(t, SEG, op), (v,))
        return
    tied = torch.from_numpy(np.round(rng.randn(2, 9, 3))).requires_grad_()
    out = seg_scan.run_bcast(tied, SEG, op)
    g = torch.from_numpy(rng.randn(2, 9, 3))
    (dv,) = torch.autograd.grad(out, tied, g)
    want = (seg_scan.run_bcast_plain(g, SEG, "sum") if op == "sum" else
            seg_scan.run_bcast_max_bwd_plain(g, tied.detach(), out.detach(), SEG))
    assert torch.equal(dv, want)


def test_conv3x3_gradcheck():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 4, 5, 3)).requires_grad_()
    w = torch.from_numpy(rng.randn(3, 3, 3, 2)).requires_grad_()
    assert torch.autograd.gradcheck(conv2d.conv3x3, (x, w))


def test_meta_tensors_reach_the_fake_implementations(monkeypatch):
    """Shapes and dtypes only: the kernels' library is never asked for."""
    def refuse(*a, **k):
        raise AssertionError("a fake implementation reached _kernels")

    monkeypatch.setattr(_kernels, "library", refuse)
    monkeypatch.setattr(_kernels, "launch", refuse)
    for name, op, args, want in _cases(torch.bfloat16):
        meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
        got = op(*meta)
        assert got.device.type == "meta", name
        assert got.shape == want.shape and got.dtype == want.dtype, name


def test_export_keeps_each_op_as_one_node():
    """A function of all five public entry points exported and run: the
    graph holds one node for each op call, and the program's outputs are
    the eager ones."""
    class Net(torch.nn.Module):
        def forward(self, vals, seg, x, w, over, valid):
            s = seg_scan.run_bcast(vals, seg, "sum")
            m = seg_scan.run_bcast(vals, seg, "max")
            y = conv2d.conv3x3(x, w)
            return (s, m, y, conv2d.conv3x3_dgrad(y, w), conv2d.conv3x3_wgrad(x, y),
                    seg_scan.run_bcast_max_bwd(s, vals, m, seg), nms.greedy_suppress(over, valid))

    _, _, (vals, seg, _), _ = _cases()[0]
    _, _, (x, w, _), _ = _cases()[4]
    _, _, (over, valid), _ = _cases()[-1]
    args = (vals, seg, x, w, over, valid)
    program = torch.export.export(Net(), args)
    calls = [n.target for n in program.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("com_tpu_torch.")]
    assert [str(t) for t in calls] == [
        "com_tpu_torch.run_bcast.default", "com_tpu_torch.run_bcast.default",
        "com_tpu_torch.conv3x3.default", "com_tpu_torch.conv3x3.default",
        "com_tpu_torch.conv3x3_wgrad.default", "com_tpu_torch.run_bcast_bwd.default",
        "com_tpu_torch.greedy_suppress.default"]
    for got, want in zip(program.module()(*args), Net()(*args)):
        assert torch.equal(got, want)
