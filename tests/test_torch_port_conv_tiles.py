"""What the tensor-core K2 and K2w leave to Python, on the CPU: the dgrad
kernel's re-layout (``rotate_kernel``, run by ``conv3x3_dgrad``), K2w's
split of the pixels into chunks of row segments (``wgrad_plan``), the
build's hash over the shared headers, and the sources that the tile sweep
(``tools/perf/conv_tiles.py``) derives from the kernels (K2, K2w in bf16
and f32, T1-T4, K1, K3, K4).

The re-layout and the chunked sum are held against ``conv3x3_plain`` /
``conv3x3_wgrad_plain`` and against the JAX package's Pallas kernels in
interpret mode (its own dgrad through ``jax.vjp``, ``_conv3x3_wgrad_pallas``),
on numpy-seeded f32 inputs, atol 1e-4 (sums taken in another order).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.ops.pallas.conv2d import _conv3x3_wgrad_pallas
from com_tpu.ops.pallas.conv2d import conv3x3 as jax_conv3x3
from com_tpu_torch.ops import _kernels, conv2d
from com_tpu_torch.tools.perf import conv_tiles

torch.set_num_threads(2)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 9, 13, 8, 5), (2, 6, 70, 3, 16)])
def test_rotated_kernel_dgrad_matches_jax(b, h, w, cin, cout):
    """dgrad as the backward runs it (``conv3x3_dgrad``: K2 on g with
    ``rotate_kernel(w)``), against the JAX package's own dgrad (its fwd kernel on the rotated,
    swapped kernel, interpret mode)."""
    rng = _rng("rot", b, h, w, cin, cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jax_conv3x3(xx, jnp.asarray(k), "interpret"), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    rot = conv2d.rotate_kernel(torch.from_numpy(k))
    assert rot.shape == (3, 3, cout, cin) and rot.is_contiguous()
    got = conv2d.conv3x3_dgrad(torch.from_numpy(g), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got, conv2d.conv3x3_plain(torch.from_numpy(g), rot).numpy())
    # the rotation is the 180-degree turn with the channel axes swapped
    np.testing.assert_array_equal(rot.numpy()[0, 2, cout - 1, 0], k[2, 0, 0, cout - 1])


@pytest.mark.parametrize("b,h,w,cin,cout,resident", [
    (2, 468, 468, 64, 64, 264), (2, 234, 234, 128, 128, 264), (2, 117, 117, 256, 256, 264),
    (1, 1, 3, 8, 8, 264), (2, 5, 130, 300, 72, 132), (1, 3, 64, 64, 64, 1)])
def test_wgrad_plan_covers_every_segment_once(b, h, w, cin, cout, resident):
    chunks, per = conv2d.wgrad_plan(b, h, w, cin, cout, resident)
    steps = b * h * -(-w // conv2d.WGRAD_SEGMENT)
    tiles = 3 * -(-cin // 64) * -(-cout // 64)
    assert 1 <= chunks <= 65535 and per >= 1
    assert (chunks - 1) * per < steps <= chunks * per  # no chunk empty, none left over
    assert chunks * tiles <= max(resident, tiles)      # at most one wave


@pytest.mark.parametrize("b,h,w,cin,cout,resident", [
    (2, 47, 35, 256, 256, 132), (2, 200, 176, 256, 128, 132), (2, 468, 468, 64, 64, 132),
    (1, 1, 3, 13, 3, 132), (2, 94, 311, 64, 64, 1)])
def test_f32_wgrad_plan(b, h, w, cin, cout, resident):
    """The f32 K2w's chunks: every segment once, no chunk empty, at most
    ``_WGRAD_WAVES[f32]`` waves of the resident blocks; the kernel, given the
    chunk count alone, cuts the same runs (ceil(segments / chunks))."""
    chunks, per = conv2d.wgrad_plan(b, h, w, cin, cout, resident, torch.float32)
    steps = b * h * -(-w // conv2d.WGRAD_SEGMENT)
    tiles = 3 * -(-cin // 64) * -(-cout // 64)
    assert 1 <= chunks <= 65535 and (chunks - 1) * per < steps <= chunks * per
    assert chunks * tiles <= max(conv2d._WGRAD_WAVES[torch.float32] * resident, tiles)
    assert -(-steps // chunks) == per


@pytest.mark.parametrize("b,h,w,cin,cout,resident", [(2, 9, 70, 8, 16, 30), (1, 7, 20, 5, 3, 9)])
def test_wgrad_chunked_sum_matches_jax(b, h, w, cin, cout, resident):
    """The bf16 K2w's arithmetic in plain PyTorch: one f32 partial for each
    chunk's row segments (the output pixels it holds), then the partials
    added in chunk order; against conv3x3_wgrad_plain and the JAX kernel."""
    rng = _rng("wgc", b, h, w, cin, cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    chunks, per = conv2d.wgrad_plan(b, h, w, cin, cout, resident)
    assert chunks > 1
    seg = conv2d.WGRAD_SEGMENT
    segs = -(-w // seg)
    # the step of each output pixel: s = (b * H + h) * segs + column // 64
    step = ((np.arange(b)[:, None, None] * h + np.arange(h)[None, :, None]) * segs
            + np.arange(w)[None, None, :] // seg)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    dw = torch.zeros((3, 3, cin, cout))
    for c in range(chunks):
        mask = torch.from_numpy(((step >= c * per) & (step < (c + 1) * per)).astype(np.float32))
        dw = dw + conv2d.conv3x3_wgrad_plain(tx, tg * mask[..., None])
    want = np.asarray(_conv3x3_wgrad_pallas(jnp.asarray(x), jnp.asarray(g), interpret=True))
    np.testing.assert_allclose(dw.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dw.numpy(), conv2d.conv3x3_wgrad_plain(tx, tg).numpy(), atol=1e-4,
                               rtol=0)


def test_library_path_hashes_shared_headers(monkeypatch, tmp_path):
    """A change to a shared header under csrc/ names a new library, so the
    kernels that include it build anew."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    before = _kernels.library_path("k")
    assert _kernels.library_path("k") == before
    header.write_text("// two\n")
    assert _kernels.library_path("k") != before


@pytest.mark.parametrize("variant", conv_tiles.DEFAULT + ("k2:4,16,5", "k2w:3,64,64,4,3"))
def test_tile_sweep_sources(variant):
    """The tile sweep's copies of the kernel sources: each constant set once,
    each diagnostic's pattern found; the shipped tiles are the sources' own."""
    kernel, values, diag = conv_tiles.parse(variant)
    text = conv_tiles.variant_source(kernel, values, diag)
    src, names = conv_tiles.CONSTANTS[kernel]
    for name, value in zip(names, values):
        assert f"constexpr int {name} = {value};" in text
    assert ("fetch(t + kStages - 1);" in text) == (diag != "noload")
    assert ("hopper::mma_bf16(" in text) == (diag != "nomma")
    if not diag and variant in conv_tiles.DEFAULT:
        assert text == (_kernels.CSRC / f"{src}.cu").read_text()
    with pytest.raises(ValueError):
        conv_tiles.parse(variant.replace(":", ":1,"))


@pytest.mark.parametrize("variant", conv_tiles.F32_DEFAULT)
def test_f32_tile_sweep_sources(variant):
    """The f32 K2's and K2w's copies in the tile sweep: each constant set
    once, each diagnostic's pattern found and only it changed (the main
    loop's fetch, the three-pass product, the TF32 split, the stages'
    round-to-nearest adds), the bf16 kernel of the same source untouched;
    the shipped tiles are the sources' own."""
    kernel, values, diag = conv_tiles.parse(variant)
    text = conv_tiles.variant_source(kernel, values, diag)
    src, names = conv_tiles.CONSTANTS[kernel]
    for name, value in zip(names, values):
        assert f"constexpr int {name} = {value};" in text
    assert (conv_tiles._F32_FETCH in text) == (diag != "noload")
    assert (conv_tiles._F32_MMA[kernel][0] in text) == (diag not in ("nomma", "inacc"))
    assert (conv_tiles._F32_FLUSH in text) == (diag != "inacc")
    assert ("hopper::split_tf32(" in text) == (diag != "nosplit")
    assert "fetch(t + kStages - 1);" in text and "hopper::mma_bf16(" in text
    shipped = (_kernels.CSRC / f"{src}.cu").read_text()
    assert (text == shipped) == (variant in conv_tiles.F32_SHIPPED)
    with pytest.raises(ValueError):
        conv_tiles.parse(variant.split(",no")[0] + ",noscan")


@pytest.mark.parametrize("variant", conv_tiles.K1_DEFAULT + ("k1:4,2,128,1,noload",
                                                            "k1:16,8,512,1,noscan"))
def test_k1_tile_sweep_sources(variant):
    """K1's copies in the tile sweep: each constant of seg_scan.cu set once,
    each diagnostic's pattern found; the first variant is the shipped
    source; the conv kernels' diagnostic is refused."""
    kernel, values, diag = conv_tiles.parse(variant)
    assert kernel == "k1"
    text = conv_tiles.variant_source(kernel, values, diag)
    for name, value in zip(conv_tiles.CONSTANTS["k1"][1], values):
        assert f"constexpr int {name} = {value};" in text
    assert ("task.fetch(row0 + r, g.c0, C, vec, raw[k]);" in text.split("k1_main(")[1]
            .split("k1_carries(")[0]) == (diag != "noload")
    assert ("block_scans<Op, VEC, kWarps>(" in text) == (diag != "noscan")
    assert ("  return (int)err;\n  // k1_carries and k1_fixup" in text) == (diag == "mainonly")
    if variant == conv_tiles.K1_DEFAULT[0]:
        assert text == (_kernels.CSRC / "seg_scan.cu").read_text()
    with pytest.raises(ValueError):
        conv_tiles.parse(variant.split(",no")[0].split(",main")[0] + ",nomma")


@pytest.mark.parametrize("variant", conv_tiles.K4_DEFAULT + conv_tiles.K3_DEFAULT)
def test_k4_k3_tile_sweep_sources(variant):
    """K4's and K3's copies in the tile sweep: each constant set once, the
    first variant of each the shipped source, K3's diagnostics applied, the
    conv kernels' diagnostics refused."""
    kernel, values, diag = conv_tiles.parse(variant)
    text = conv_tiles.variant_source(kernel, values, diag)
    src, names = conv_tiles.CONSTANTS[kernel]
    for name, value in zip(names, values):
        assert f"constexpr int {name} = {value};" in text
    shipped = (_kernels.CSRC / f"{src}.cu").read_text()
    assert (text == shipped) == (variant in (conv_tiles.K4_DEFAULT[0], conv_tiles.K3_DEFAULT[0]))
    assert (conv_tiles._K3_EXP in text) == (kernel == "k3" and diag != "noexp")
    assert (conv_tiles._K3_CELLS in text) == (kernel == "k3" and diag != "nocells")
    with pytest.raises(ValueError):
        conv_tiles.parse(variant.split(",no")[0] + ",noload")


# the kernel function each T variant's diagnostics edit (T1 and T4 share one)
_T_FUNCTION = {"t1": "gtcol", "t2": "xcol", "t3": "gt9", "t4": "gtcol"}


def _check_t_variant_source(variant):
    kernel, values, diag = conv_tiles.parse(variant)
    text = conv_tiles.variant_source(kernel, values, diag)
    for name, value in zip(conv_tiles.CONSTANTS[kernel][1], values):
        assert f"constexpr int {name} = {value};" in text
    lines = {d: line for d, (line, _) in conv_tiles._T_DIAGS[kernel].items()}
    lines.setdefault("nomma", "hopper::mma_bf16(")  # T2's products: K2's and K2w's pattern
    for d, line in lines.items():
        assert (line in text) == (diag != d), d
    for other, fn in _T_FUNCTION.items():
        if fn != _T_FUNCTION[kernel]:  # the other kernels' lines stay
            for line, _ in conv_tiles._T_DIAGS[other].values():
                assert line in text, (other, line)
    shipped = (_kernels.CSRC / "wgrad_variants.cu").read_text()
    assert (text == shipped) == (variant in conv_tiles.T_SHIPPED)
    for bad in (",noexp", ",mainonly", ",1"):
        with pytest.raises(ValueError):
            conv_tiles.parse(variant.split(",no")[0] + bad)
    return kernel, text


@pytest.mark.parametrize("variant", [v for v in conv_tiles.T_DEFAULT if v[:2] in ("t2", "t4")])
def test_t2_t4_tile_sweep_sources(variant):
    """T2's and T4's copies in the tile sweep: each constant of
    wgrad_variants.cu set once, each diagnostic's line of its own kernel
    found (the loads, the products, the column buffer) and only that one
    changed; the first of each the shipped source; other kernels'
    diagnostics refused."""
    kernel, _ = _check_t_variant_source(variant)
    assert kernel in ("t2", "t4")


@pytest.mark.parametrize("variant", [v for v in conv_tiles.T_DEFAULT if v[:2] in ("t1", "t3")])
def test_t1_t3_tile_sweep_sources(variant):
    """T1's and T3's copies in the tile sweep, as T2's and T4's: each
    diagnostic replaces a line of its own kernel (T1's the templated kernel
    it shares with T4), T3 has no column buffer to drop, and ``viewbase``
    takes T3's base-offset field from the view's start address."""
    kernel, text = _check_t_variant_source(variant)
    assert kernel in ("t1", "t3")
    shipped = (_kernels.CSRC / "wgrad_variants.cu").read_text()
    own = shipped.split(f"{_T_FUNCTION[kernel]}_kernel(Args a) {{")[1].split("\n}\n")[0]
    for d, (line, _) in conv_tiles._T_DIAGS[kernel].items():
        assert (line in own) == (d != "viewbase"), d  # viewbase edits the descriptor helper
    assert ("smem_addr(block + row * 64) >> 7" in text) == variant.endswith(",viewbase")
    with pytest.raises(ValueError):
        conv_tiles.parse(f"{kernel}:4,{'viewbase' if kernel == 't1' else 'nocol'}")


def test_host_cost_needs_a_card():
    """The wrappers' host-cost tool times CUDA launches only: it refuses the
    CPU before it builds or allocates anything."""
    from com_tpu_torch.tools.perf import host_cost

    with pytest.raises(RuntimeError):
        host_cost.run(device="cpu")
