"""The f32 K2 / K2w's three-pass TF32 arithmetic, emulated on the CPU.

The card's f32 kernels split each operand as the tensor cores are fed:
``hi`` = the f32 value rounded to TF32 (add half of TF32's last bit, then
truncate: ``hopper::split_tf32``), ``lo`` = value - hi, which the tensor
cores truncate to TF32; each product is lo*hi + hi*lo + hi*hi.  Here the
same bits are made with integer ops in torch, the three products are summed
exactly (f64), and the result is held against the JAX package's conv3x3 and
its weight gradient (the Pallas kernels in interpret mode, as the JAX tests
run them) within the card's gate, 1e-5 * conv(|x|, |w|) with no rounding
allowance.  One TF32 product alone (hi*hi) fails that gate: the reason the
kernels take three.  The layout is CaDDN's third BEV block's, (2, 47, 35),
its 256 channels narrowed to 16.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.ops.pallas.conv2d import _conv3x3_fwd_pallas, _conv3x3_wgrad_pallas
from com_tpu_torch.ops import conv2d

torch.set_num_threads(2)
GATE = 1e-5  # the card's f32 gate: |err| <= GATE * the same op on |x|, |w|
SHAPES = [(2, 47, 35, 16, 16), (1, 47, 35, 13, 8)]  # (B, H, W, Cin, Cout)


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def tf32_hi(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the kernels round their hi parts: + 0x1000, then the
    low 13 bits cleared (to nearest, ties away from zero)."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the tensor cores read an operand: low 13 bits dropped."""
    return (t.view(torch.int32) & -0x2000).view(torch.float32)


def split(t: torch.Tensor):
    """(hi, lo) as the tensor cores see them, in f64 (exact)."""
    hi = tf32_hi(t)
    return hi.double(), tf32_trunc(t - hi).double()


def three_pass(op, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op(a, b) bilinear, as lo*hi + hi*lo + hi*hi of the TF32 splits."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (op(al, bh) + op(ah, bl) + op(ah, bh)).float()


def _inputs(b, h, w, cin, cout):
    rng = _rng(b, h, w, cin, cout)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.randn(b, h, w, cout).astype(np.float32)
    return x, k, g


def test_split_holds_each_value_to_2_21():
    """hi + lo (the tensor cores' truncation of lo) holds any f32 to 2^-21
    of its magnitude; hi alone only to 2^-11."""
    t = torch.from_numpy(_rng("split").randn(100_000).astype(np.float32) * 37.0)
    hi, lo = split(t)
    rel = ((hi + lo) - t.double()).abs() / t.double().abs()
    assert float(rel.max()) <= 2.0 ** -21
    hi_rel = float(((hi - t.double()).abs() / t.double().abs()).max())
    assert 2.0 ** -12 < hi_rel <= 2.0 ** -11


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_three_pass_conv3x3_within_the_gate(b, h, w, cin, cout):
    x, k, _ = _inputs(b, h, w, cin, cout)
    want = np.asarray(_conv3x3_fwd_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True))
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    scale = conv2d.conv3x3_plain(tx.abs().double(), tk.abs().double()).numpy()
    got = three_pass(conv2d.conv3x3_plain, tx, tk).numpy()
    assert np.all(np.abs(got - want) <= GATE * scale)
    one = conv2d.conv3x3_plain(tf32_hi(tx).double(), tf32_hi(tk).double()).float().numpy()
    assert np.any(np.abs(one - want) > GATE * scale)  # one TF32 product is not enough


@pytest.mark.parametrize("b,h,w,cin,cout", SHAPES)
def test_three_pass_wgrad_within_the_gate(b, h, w, cin, cout):
    x, _, g = _inputs(b, h, w, cin, cout)
    want = np.asarray(_conv3x3_wgrad_pallas(jnp.asarray(x), jnp.asarray(g), interpret=True))
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    scale = conv2d.conv3x3_wgrad_plain(tx.abs().double(), tg.abs().double()).numpy()
    got = three_pass(conv2d.conv3x3_wgrad_plain, tx, tg).numpy()
    assert np.all(np.abs(got - want) <= GATE * scale)
    one = conv2d.conv3x3_wgrad_plain(tf32_hi(tx).double(), tf32_hi(tg).double()).float().numpy()
    assert np.any(np.abs(one - want) > GATE * scale)
