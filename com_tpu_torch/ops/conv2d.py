"""3x3 stride-1 SAME convolution over NHWC feature maps, with gradient
(kernels K2 and K2w).

Counterpart of ``com_tpu/ops/pallas/conv2d.py``: every stride-1, bias-free
3x3 conv of the BEV backbone.  Layouts are the JAX package's: x is
(B, H, W, Cin), w is HWIO (3, 3, Cin, Cout); accumulation is f32 and the
output has x's dtype.

``conv3x3`` and its gradients are reached through two registered ops
(``torch.library.custom_op``), so that ``torch.export`` traces a step
through them and a loaded program calls them: ``com_tpu_torch::conv3x3``
(K2: the forward, or with ``dgrad`` the input gradient) and
``com_tpu_torch::conv3x3_wgrad`` (K2w).  The forward's gradient, registered
with ``register_autograd``, follows ``_conv3x3_bwd`` (``conv2d.py:537-555``):
the input gradient (dgrad) is K2 again on the output gradient with the
kernel rotated 180 degrees and its channel axes swapped
(``rotate_kernel``); the weight gradient is K2w, f32 (3, 3, Cin, Cout) cast
to w's dtype.  Each op launches its CUDA kernel (``csrc/conv3x3.cu``,
``csrc/conv3x3_wgrad.cu``) for a CUDA tensor, on the tensor cores in both
dtypes: bf16 products, and f32 as three TF32 products a pair of operands
(each split into a TF32 head and tail), to about 2^-20 of sum |x||w|.  For
a CPU tensor each runs its plain version
(``conv3x3_plain``, ``conv3x3_wgrad_plain``); a fake implementation gives
shapes only.  The TPU kernel's split of wide inputs into <=128-channel
slices existed only for the TPU's VMEM and is not carried over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels

launches = 0        # K2 launches by conv3x3's forward since the last reset
dgrad_launches = 0  # K2 launches by conv3x3's backward (dgrad) since the last reset
wgrad_launches = 0  # K2w launches since the last reset

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}  # the C entry points' dtype suffix
# K2w's grid: this many waves of the blocks a card holds at once, its row
# segments cut into equal runs, one f32 partial each.  bf16: one wave (3-4
# blocks an SM).  f32: one block an SM, so at the small maps one wave leaves
# SMs idle (CaDDN's (2,47,35,256): 48 tiles, 2 chunks, 96 blocks); two
# waves fill them at the cost of twice the partials to add
_WGRAD_WAVES = {torch.float32: 2, torch.bfloat16: 1}
WGRAD_SEGMENT = 64  # the widest row segment: K2w's step is ceil(W / 64) equal ones a row
_resident_blocks: dict[tuple[int, torch.dtype], int] = {}  # (device, dtype) -> K2w blocks at once


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nine shifted (B*H*W, Cin) @ (Cin, Cout)
    products summed in f32 (f64 for f64 input, which only the gradient
    checks use) over the zero-padded input."""
    b, h, wd, _ = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    wf = w.to(acc_dtype)
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
            acc = t if acc is None else acc + t
    return acc.to(x.dtype)


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight gradient: nine shifted
    (B*H*W, Cin)^T @ (B*H*W, Cout) products in f32 (``conv2d.py:350-361``;
    f64 for f64 input)."""
    b, h, wd, cin = x.shape
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc_dtype), (0, 0, 1, 1, 1, 1))
    gf = g.to(acc_dtype).reshape(b * h * wd, -1)
    taps = [xp[:, dy:dy + h, dx:dx + wd, :].reshape(b * h * wd, cin).t() @ gf
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, gf.shape[-1])


def rotate_kernel(w: torch.Tensor) -> torch.Tensor:
    """The dgrad kernel: w (3, 3, Cin, Cout) rotated 180 degrees with its
    channel axes swapped, (3, 3, Cout, Cin), contiguous."""
    return w.flip(0).flip(1).transpose(2, 3).contiguous()


def wgrad_plan(b: int, h: int, wd: int, cin: int, cout: int, resident: int,
               dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(chunks, steps a chunk) of K2w in ``dtype``: its B * H * ceil(W / 64)
    row segments cut into equal runs, one f32 partial each, so that the grid
    (3 * ceil(Cin / 64) * ceil(Cout / 64) tiles x chunks) is
    ``_WGRAD_WAVES[dtype]`` waves of the ``resident`` blocks the card holds
    at once.  No chunk is empty."""
    steps = b * h * -(-wd // WGRAD_SEGMENT)
    tiles = 3 * -(-cin // 64) * -(-cout // 64)
    chunks = max(1, min(_WGRAD_WAVES[dtype] * resident // tiles, steps, 65535))
    per = -(-steps // chunks)
    return -(-steps // per), per


def _check(x, w, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in _SUFFIX or w.dtype != x.dtype:
        raise TypeError(f"{what}: {x.dtype} and {w.dtype} (want one of f32/bf16)")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous on one device")


def _k2(x: torch.Tensor, w: torch.Tensor, counter: str) -> torch.Tensor:
    """One K2 call: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  A launch adds one to the module counter named ``counter``
    (``launches`` or ``dgrad_launches``).  The f32 kernel reads w K-major,
    (3, 3, Cout, Cin): copied here from the HWIO w (a view whose channel
    axes swapped back are contiguous is not copied)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w {tuple(w.shape)}")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        w = w.transpose(2, 3).contiguous()
    _check(x, w, "conv3x3")
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _kernels.launch("conv3x3", f"k2_conv3x3_{_SUFFIX[x.dtype]}", "conv3x3 (K2)", x.get_device(),
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, cout)
    globals()[counter] += 1
    return y


@torch.library.custom_op("com_tpu_torch::conv3x3_wgrad", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _conv3x3_wgrad_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2w as a registered op: the kernel for CUDA tensors (counted in
    ``wgrad_launches``), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and g {tuple(g.shape)}")
    _check(x, g, "conv3x3_wgrad")
    b, h, wd, cin = x.shape
    cout = g.shape[-1]
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    if x.numel() == 0 or g.numel() == 0:
        return dw.zero_()
    sfx = _SUFFIX[x.dtype]
    key = (x.device.index, x.dtype)
    if key not in _resident_blocks:
        with torch.cuda.device(x.device):
            cap = getattr(_kernels.library("conv3x3_wgrad"), f"k2w_resident_blocks_{sfx}")()
        if cap <= 0:
            raise RuntimeError("conv3x3_wgrad (K2w): occupancy query failed")
        _resident_blocks[key] = cap
    chunks, per = wgrad_plan(b, h, wd, cin, cout, _resident_blocks[key], x.dtype)
    args = (chunks, per) if x.dtype == torch.bfloat16 else (chunks,)  # f32: per from chunks
    part = torch.empty((chunks, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    _kernels.launch("conv3x3_wgrad", f"k2w_conv3x3_wgrad_{sfx}", "conv3x3_wgrad (K2w)",
                    x.get_device(), x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
                    b, h, wd, cin, cout, *args)
    global wgrad_launches
    wgrad_launches += 1
    return dw


@_conv3x3_wgrad_op.register_fake
def _(x, g):
    return x.new_empty((3, 3, x.shape[-1], g.shape[-1]),
                       dtype=torch.promote_types(x.dtype, torch.float32))


@torch.library.custom_op("com_tpu_torch::conv3x3", mutates_args=(), device_types=("cpu", "cuda"))
def _conv3x3_op(x: torch.Tensor, w: torch.Tensor, dgrad: bool) -> torch.Tensor:
    """K2 as a registered op: the kernel for CUDA tensors, the plain version
    for CPU tensors.  With ``dgrad`` it is the forward conv's input gradient:
    x is the output gradient and w the forward's kernel, rotated here
    (``rotate_kernel``); its launches count in ``dgrad_launches``, the
    forward's in ``launches``."""
    if dgrad:
        if x.device.type == "cuda" and x.dtype == torch.float32:
            # the rotated kernel as a view: K-major, as the f32 kernel reads
            # it, it is the kernel flipped, so no transpose is copied
            return _k2(x, w.flip(0, 1).transpose(2, 3), "dgrad_launches")
        return _k2(x, rotate_kernel(w), "dgrad_launches")
    return _k2(x, w, "launches")


@_conv3x3_op.register_fake
def _(x, w, dgrad):
    return x.new_empty((*x.shape[:3], w.shape[2] if dgrad else w.shape[3]))


def _setup_context(ctx, inputs, output):
    x, w, dgrad = inputs
    ctx.dgrad = dgrad
    ctx.save_for_backward(x, w)


def _backward(ctx, grad):
    if ctx.dgrad:
        raise NotImplementedError("conv3x3: the input gradient has no gradient of its own")
    x, w = ctx.saved_tensors
    g = grad.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = conv3x3_dgrad(g, w).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = conv3x3_wgrad(x, g).to(w.dtype)
    return dx, dw, None


_conv3x3_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC (B, H, W, Cin) x HWIO (3, 3, Cin, Cout),
    differentiable in x and w."""
    _kernels.check_device("conv3x3", x)
    return _conv3x3_op(x, w, False)


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``conv3x3`` (K2 dgrad): the output gradient g
    (B, H, W, Cout) correlated with the spatially rotated, in/out-swapped
    kernel, again a 3x3 SAME conv, (B, H, W, Cin) in g's dtype."""
    _kernels.check_device("conv3x3_dgrad", g)
    return _conv3x3_op(g, w.to(g.dtype), True)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of ``conv3x3`` (kernel K2w): (3, 3, Cin, Cout) f32
    from x (B, H, W, Cin) and the output gradient g (B, H, W, Cout)."""
    _kernels.check_device("conv3x3_wgrad", x)
    return _conv3x3_wgrad_op(x, g)
