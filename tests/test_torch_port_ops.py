"""The port's kernel modules and geometry ops against the JAX package, on
the CPU.

Same numpy-seeded inputs into both.  On the JAX side the Pallas kernels run
as ``com_tpu``'s own tests run them (interpret mode); on the port's side a
CPU tensor takes the kernel's plain version.  Tolerances: f32 atol 1e-4,
exact where the op is exact (max, keep masks, ids, selections).
"""
import ctypes
import re
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.ops import iou as jax_iou
from com_tpu.ops import nms as jax_nms
from com_tpu.ops.pallas.conv2d import conv3x3 as jax_conv3x3
from com_tpu.ops.pallas.nms_kernel import greedy_suppress_pallas
from com_tpu.ops.pallas.seg_scan import run_bcast as jax_run_bcast
from com_tpu.ops.voxelize import point_voxel_ids as jax_point_voxel_ids
from com_tpu_torch.ops import _kernels, conv2d, nms, seg_scan
from com_tpu_torch.ops.iou import boxes_iou_aligned_bev, boxes_iou_bev
from com_tpu_torch.ops.voxelize import point_voxel_ids

torch.set_num_threads(2)
ATOL = 1e-4


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("b,n,nseg", [
    (2, 300, 10),        # below one 1024-row tile
    (1, 2 * 1024, 1),    # one run over the whole sample
    (3, 3 * 1024, 700),  # runs crossing tile boundaries
    (2, 1024 + 17, 1024),  # mostly single-row runs, ragged tail
])
def test_run_bcast_matches_jax(op, b, n, nseg):
    rng = _rng("rb", op, b, n, nseg)
    seg = np.sort(rng.randint(0, nseg, (b, n)), axis=1).astype(np.int32)
    vals = rng.randn(b, n, 8).astype(np.float32)
    want = np.asarray(jax_run_bcast(jnp.asarray(vals), jnp.asarray(seg), op, "interpret"))
    got = seg_scan.run_bcast(torch.from_numpy(vals), torch.from_numpy(seg), op).numpy()
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_run_bcast_bf16_max_matches_jax():
    """The PFN feedback case: bf16, 32 lanes, exact."""
    rng = _rng("rb16")
    seg = np.sort(rng.randint(0, 90, (2, 1500)), axis=1).astype(np.int32)
    vals = jnp.asarray(rng.randn(2, 1500, 32).astype(np.float32)).astype(jnp.bfloat16)
    want = np.asarray(jax_run_bcast(vals, jnp.asarray(seg), "max", "interpret").astype(jnp.float32))
    tv = torch.from_numpy(np.array(vals.astype(jnp.float32))).to(torch.bfloat16)
    got = seg_scan.run_bcast(tv, torch.from_numpy(seg), "max")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_run_bcast_samples_do_not_mix():
    vals = torch.ones((2, 50, 4))
    seg = torch.zeros((2, 50), dtype=torch.int32)
    out = seg_scan.run_bcast(vals, seg, "sum")
    assert torch.equal(out, torch.full((2, 50, 4), 50.0))


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 48, 36, 8, 16), (1, 50, 36, 8, 8),
                                            (1, 17, 13, 16, 4)])
def test_conv3x3_matches_jax(b, h, w, cin, cout):
    rng = _rng("cv", b, h, w, cin, cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(k), "interpret"))
    got = conv2d.conv3x3(torch.from_numpy(x), torch.from_numpy(k))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, w, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_conv3x3_bf16_keeps_dtype():
    x = torch.randn(1, 9, 7, 4).to(torch.bfloat16)
    w = torch.randn(3, 3, 4, 6).to(torch.bfloat16)
    y = conv2d.conv3x3(x, w)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                                     padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(y.float(), ref.to(torch.bfloat16).float(), atol=0.05, rtol=0.02)


@pytest.mark.parametrize("k,density", [(300, 0.05), (128, 0.3), (500, 0.01), (65, 0.05),
                                       (129, 0.05), (1024, 0.001)])
def test_greedy_suppress_matches_jax(k, density):
    rng = _rng("gs", k, density)
    over = rng.rand(2, k, k) < density
    valid = rng.rand(2, k) < 0.9
    got = nms.greedy_suppress(torch.from_numpy(over), torch.from_numpy(valid)).numpy()
    for i in range(2):
        want = np.asarray(greedy_suppress_pallas(jnp.asarray(over[i]), jnp.asarray(valid[i]),
                                                 interpret=True))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("case", ["first_suppresses_all", "none_valid", "all_valid_chain"])
def test_greedy_suppress_structured_cases_match_jax(case):
    """Every candidate suppressed by the first; no candidate valid; every
    candidate valid with each suppressing only the next (a chain: every
    other one kept), at K = 129 (a ragged last 64-bit word)."""
    k = 129
    over = np.eye(k, dtype=bool)[None].repeat(2, 0)
    valid = np.ones((2, k), bool)
    if case == "first_suppresses_all":
        over[:, 0] = True
    elif case == "none_valid":
        over[:] = _rng("gs0").rand(2, k, k) < 0.3
        valid[:] = False
    else:
        over[:, np.arange(k - 1), np.arange(1, k)] = True
    got = nms.greedy_suppress(torch.from_numpy(over), torch.from_numpy(valid)).numpy()
    for i in range(2):
        want = np.asarray(greedy_suppress_pallas(jnp.asarray(over[i]), jnp.asarray(valid[i]),
                                                 interpret=True))
        np.testing.assert_array_equal(got[i], want)
    expect = {"first_suppresses_all": 1, "none_valid": 0, "all_valid_chain": (k + 1) // 2}
    assert got.sum(1).tolist() == [expect[case]] * 2


def _boxes(rng, b, k, spread=20.0):
    bx = np.zeros((b, k, 7), np.float32)
    bx[..., :2] = rng.uniform(-spread, spread, (b, k, 2))
    bx[..., 2] = rng.uniform(-1, 1, (b, k))
    bx[..., 3:6] = rng.uniform(0.5, 5.0, (b, k, 3))
    bx[..., 6] = rng.uniform(-np.pi, np.pi, (b, k))
    return bx


def test_boxes_iou_bev_matches_jax():
    rng = _rng("iou")
    a = _boxes(rng, 1, 60, spread=5.0)[0]
    b = _boxes(rng, 1, 50, spread=5.0)[0]
    b[:10] = a[:10]  # identical pairs
    b[10:15] = a[10:15] * np.array([1, 1, 1, 0.5, 0.5, 1, 1], np.float32)  # nested
    b[15] = 0.0  # a zero-size padded box
    for port_fn, jax_fn in ((boxes_iou_bev, jax_iou.boxes_iou_bev),
                            (boxes_iou_aligned_bev, jax_iou.boxes_iou_aligned_bev)):
        want = np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b), xp=jnp))
        got = port_fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # leading batch dimensions give the per-sample matrices
    batched = boxes_iou_bev(torch.from_numpy(np.stack([a, a])), torch.from_numpy(np.stack([b, b])))
    np.testing.assert_array_equal(batched[0].numpy(), batched[1].numpy())


@pytest.mark.parametrize("kind", ["rotated", "circle"])
def test_nms_matches_jax(kind):
    rng = _rng("nms", kind)
    b, k, post = 2, 200, 80
    boxes = _boxes(rng, b, k, spread=12.0)
    scores = np.round(rng.rand(b, k), 2).astype(np.float32)  # with exact ties
    valid = rng.rand(b, k) < 0.8
    tb, ts, tv = (torch.from_numpy(v) for v in (boxes, scores, valid))
    if kind == "rotated":
        sel, sel_valid = nms.nms_bev(tb, ts, tv, 0.3, post)
    else:
        sel, sel_valid = nms.circle_nms(tb[..., :2], ts, tv, 4.0, post)
    sel, sel_valid = sel.numpy(), sel_valid.numpy()
    assert sel.shape == sel_valid.shape == (b, post)
    for i in range(b):
        if kind == "rotated":
            js, jv = jax_nms.nms_bev(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                     jnp.asarray(valid[i]), 0.3, post)
        else:
            js, jv = jax_nms.circle_nms(jnp.asarray(boxes[i, :, :2]), jnp.asarray(scores[i]),
                                        jnp.asarray(valid[i]), 4.0, post)
        js, jv = np.asarray(js), np.asarray(jv)
        np.testing.assert_array_equal(sel_valid[i], jv)
        assert jv.sum() > 5
        np.testing.assert_array_equal(sel[i][jv], js[jv])


@pytest.mark.parametrize("call", [
    lambda d: seg_scan.run_bcast(torch.zeros((1, 4, 2), device=d),
                                 torch.zeros((1, 4), dtype=torch.int32, device=d)),
    lambda d: conv2d.conv3x3(torch.zeros((1, 4, 4, 2), device=d), torch.zeros((3, 3, 2, 2), device=d)),
    lambda d: nms.greedy_suppress(torch.zeros((1, 3, 3), dtype=torch.bool, device=d),
                                  torch.ones((1, 3), dtype=torch.bool, device=d)),
], ids=["run_bcast", "conv3x3", "greedy_suppress"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(call):
    """A tensor that is on neither the CPU nor a CUDA card raises: the
    plain version is chosen by the CPU device, never as a fallback."""
    before = (seg_scan.launches, conv2d.launches, nms.launches)
    assert call("cpu") is not None
    with pytest.raises(ValueError, match="unsupported device meta"):
        call("meta")
    assert (seg_scan.launches, conv2d.launches, nms.launches) == before


def test_launch_makes_the_device_current_only_when_it_is_not(monkeypatch):
    """``_kernels.launch`` calls the C entry with the current stream's raw
    handle appended, enters the device's context only for a device that is
    not current, and raises on the error the entry returns."""
    calls, entered = [], []

    class Lib:
        def k(self, *args):
            calls.append(args)
            return args[0]

    class DeviceContext:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setitem(_kernels._libs, "fake", Lib())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", DeviceContext)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i, raising=False)
    _kernels.launch("fake", "k", "fake kernel", 0, 0, 7)
    _kernels.launch("fake", "k", "fake kernel", 1, 0, 8)
    assert calls == [(0, 7, 1000), (0, 8, 1001)] and entered == [1]
    with pytest.raises(RuntimeError, match="fake kernel: CUDA error 3"):
        _kernels.launch("fake", "k", "fake kernel", 0, 3)


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


@pytest.mark.parametrize("name", _kernels.KERNELS)
def test_ctypes_signatures_match_the_sources(name):
    """Every C entry point of csrc/<name>.cu is declared for ctypes with its
    return type and one argtype per parameter, pointers as c_void_p and
    floats as c_float."""
    src = (_kernels.CSRC / f"{name}.cu").read_text()
    decls = {m.group(2): (m.group(1), m.group(3)) for m in re.finditer(
        r'extern "C" (int|long long) (\w+)\(([^)]*)\)', src)}
    assert set(decls) == set(_kernels.SIGNATURES[name])
    for fn, (ret, params) in decls.items():
        restype, argtypes = _kernels.SIGNATURES[name][fn]
        params = [p.strip() for p in params.split(",") if p.strip()]
        assert restype is _C_TYPES[ret], fn
        assert len(argtypes) == len(params), fn
        for p, t in zip(params, argtypes):
            want = (ctypes.c_void_p if "*" in p
                    else ctypes.c_float if p.startswith("float ") else ctypes.c_int)
            assert t is want, (fn, p)


def test_wgrad_variants_library_holds_t1_to_t4():
    """One source, csrc/wgrad_variants.cu, holds all four wgrad variants:
    each wrapper's C entry and occupancy query are declared there with one
    signature (the chunk plan's arguments after th), and no other library
    lists them."""
    from com_tpu_torch.ops import wgrad_variants

    sigs = _kernels.SIGNATURES["wgrad_variants"]
    assert set(wgrad_variants.PREFIX) == set(wgrad_variants.VARIANTS)
    assert sorted(wgrad_variants.PREFIX.values()) == ["t1", "t2", "t3", "t4"]
    want = set()
    for name, prefix in wgrad_variants.PREFIX.items():
        entry, query = f"{prefix}_wgrad_{name}", f"{prefix}_resident_blocks"
        assert sigs[entry] == sigs["t2_wgrad_xcol"] and len(sigs[entry][1]) == 13
        assert sigs[query] == (ctypes.c_int, ())
        want |= {entry, query}
    assert set(sigs) == want
    assert set(_kernels.SIGNATURES) == set(_kernels.KERNELS)
    assert sorted(p.stem for p in _kernels.CSRC.glob("*.cu")) == sorted(_kernels.KERNELS)


def test_build_all_waits_for_every_nvcc(monkeypatch, tmp_path):
    """One compiler process per source, all started before any is waited
    on; a failure is raised after every process has ended, and only the
    sources that built are installed."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    'out=""; prev=""\n'
                    'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
                    'case "$out" in *libseg_scan*) echo "seg_scan.cu: error"; exit 1;; esac\n'
                    'echo "ptxas info    : Used 10 registers"; : > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed for seg_scan.cu"):
        _kernels.build_all()
    built = sorted(p.name.split("-")[0] for p in (tmp_path / "build").glob("*.so"))
    assert built == sorted(f"lib{n}" for n in _kernels.KERNELS if n != "seg_scan")
    assert "Used 10 registers" in _kernels.library_path("nms").with_suffix(".log").read_text()
    paths = _kernels.build_all(("nms", "conv3x3"))  # built ones are not rebuilt
    assert all(p.exists() for p in paths.values())


def test_point_voxel_ids_matches_jax():
    rng = _rng("vox")
    pc_range = (-10.24, -10.24, -2.0, 10.24, 10.24, 4.0)
    vsize, grid = (0.32, 0.32, 6.0), (64, 64, 1)
    pts = rng.uniform(-11, 11, (2, 3000, 3)).astype(np.float32)
    # points on pillar edges, where any other rounding would move them
    edges = (np.arange(-32, 33) * np.float32(0.32)).astype(np.float32)
    pts[0, :65, 0] = edges
    pts[0, :65, 1] = edges[::-1]
    pts[1, :10, 2] = np.float32(4.0)
    want_ids, want_in = (np.asarray(v) for v in jax_point_voxel_ids(
        jnp.asarray(pts), pc_range, vsize, grid))
    got_ids, got_in = point_voxel_ids(torch.from_numpy(pts), pc_range, vsize, grid)
    np.testing.assert_array_equal(got_in.numpy(), want_in)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
