"""Sparse 3D convolution engine: rulebooks, one gather and one wide GEMM a
conv (counterpart of ``com_tpu/ops/sparse.py``, its default v2 engine).

Active voxels live in fixed-size arrays a scene: (V, C) features, (V, 3)
zyx int coords and a (V,) valid mask; every shape is static, and nothing
here reads a value back to the host or copies one to the device.  A conv is

* a rulebook: (K3, Q) rows of the input array for each tap and query site,
  -1 where the neighbour is empty.  Sites are found in a dense
  cell -> row int32 table when the scene's grid has at most
  ``DENSE_CELL_CAP`` cells, else by a binary search over the sorted flat
  keys (``_lookup``).  A submanifold rulebook probes half the taps and
  recovers the mirror taps by inversion (``subm_rulebook``); a strided one
  probes the output table from the input side (``_strided_rulebook_
  outprobe``);
* one gather of every tap's rows into (Q, K3*Cin) patches and one
  (Q, K3*Cin) @ (K3*Cin, Cout) product (``torch.matmul``: the JAX package
  computes it outside any Pallas kernel).

The backward is gather-only (``Im2colGEMM``): dW from recomputed patches;
dfeatures by gathering the patch gradient through a table of each input
row's (output, tap) uses: the mirrored rulebook for a submanifold conv (as
the JAX package's ``_subm_im2col_mirror``), the input-side hits the outprobe
found for a strided one (the JAX package lets autodiff scatter-add there;
the sum is the same, in another order).

An inverse conv (``batched_inverse_conv3d``, UNetV2's decoder) looks each
high-resolution site's (c - off) / s up in the low-resolution table; its
backward gathers through the one-to-one inverse of that rulebook.
``batched_voxel_query`` (Voxel-RCNN's RoI pooling) looks its queries'
offset cubes up through the same tables, a chunk of offsets at a time.

Caps, overflow and tables are per scene, as under the JAX package's
``jax.vmap``.  The engine runs a whole batch at once: the scene index is
folded into the keys (a scene's cells are ``b * cells + key``), so one
table or sort serves the batch, and each conv's gather and product run once
over the stacked scenes.  The per-scene functions (``subm_rulebook``,
``downsample_sites``, ``strided_rulebook``, ``submanifold_conv3d``,
``strided_conv3d``, ``inverse_conv3d``, ``scatter_to_dense``) are the
batch of one.  Only the
JAX engine's default behaviour is ported (its ``COM_TPU_SPARSE*`` switches
are not read).  Weights are (K3, Cin, Cout), taps in the row-major
(dz, dy, dx) order of the kernel cube.
"""
from __future__ import annotations

import numpy as np
import torch

DENSE_CELL_CAP = 100_000_000  # scenes of up to this many cells use the dense table
_KEY_SENTINEL = torch.iinfo(torch.int64).max  # the key of an invalid site


def _dims(grid_zyx):
    return tuple(int(g) for g in grid_zyx)


def _triple(v):
    return (int(v),) * 3 if np.isscalar(v) else tuple(int(k) for k in v)


def use_dense_lookup(grid_zyx) -> bool:
    nz, ny, nx = _dims(grid_zyx)
    return nz * ny * nx <= DENSE_CELL_CAP


def flat_key(coords: torch.Tensor, grid_zyx, valid: torch.Tensor) -> torch.Tensor:
    """(..., 3) zyx int coords -> unique int64 key; invalid -> the sentinel."""
    _, ny, nx = _dims(grid_zyx)
    c = coords.to(torch.int64)
    key = (c[..., 0] * ny + c[..., 1]) * nx + c[..., 2]
    return torch.where(valid, key, torch.full_like(key, _KEY_SENTINEL))


def _scene_keys(coords, grid_zyx, valid):
    """(B, ..., 3) -> keys with the scene folded in (b * cells + key),
    invalid -> the sentinel."""
    nz, ny, nx = _dims(grid_zyx)
    b = torch.arange(coords.shape[0], device=coords.device).view(-1, *([1] * (coords.dim() - 2)))
    key = flat_key(coords, grid_zyx, valid)
    return torch.where(valid, key + b * (nz * ny * nx), key)


def _cube(lo, hi, device):
    """(K, 3) int64 zyx points of the box [lo, hi) an axis, row-major."""
    axes = [torch.arange(a, b, device=device) for a, b in zip(lo, hi)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)


def _in_grid(nc, grid_zyx, valid):
    nz, ny, nx = _dims(grid_zyx)
    return ((nc[..., 0] >= 0) & (nc[..., 0] < nz) & (nc[..., 1] >= 0) & (nc[..., 1] < ny)
            & (nc[..., 2] >= 0) & (nc[..., 2] < nx) & valid)


def _lookup_fn(coords, valid, grid_zyx):
    """A finder of rows (int64, -1 where empty) of the (B, V) sites for
    (K, B, Q) blocks of queries, each in its own scene: the dense cell ->
    row table (one scatter into a (B * cells + 1,) int32 buffer, the last
    cell a drop slot) when a scene's grid is small enough, else the sorted
    keys.  The table or the sort is made once, for every block asked."""
    b, v = valid.shape
    keys = _scene_keys(coords, grid_zyx, valid)
    rows = torch.arange(v, device=coords.device).expand(b, v)
    if use_dense_lookup(grid_zyx):
        nz, ny, nx = _dims(grid_zyx)
        drop = b * nz * ny * nx
        table = torch.full((drop + 1,), -1, dtype=torch.int32, device=coords.device)
        table[torch.where(valid, keys, drop)] = rows.to(torch.int32)

        def find(qkeys, miss):
            return table[torch.where(miss, drop, qkeys)].to(torch.int64)
    else:
        order = torch.argsort(keys.reshape(-1), stable=True)
        skeys = keys.reshape(-1)[order]

        def find(qkeys, miss):
            pos = torch.searchsorted(skeys, qkeys.reshape(-1)).clamp_(0, skeys.shape[0] - 1)
            return torch.where(skeys[pos] == qkeys.reshape(-1), order[pos] % v,
                               -1).view(qkeys.shape)

    def lookup(qcoords, qok):
        qkeys = _scene_keys(qcoords.transpose(0, 1), grid_zyx,
                            qok.transpose(0, 1)).transpose(0, 1)
        miss = qkeys == _KEY_SENTINEL
        return torch.where(miss, -1, find(qkeys, miss))

    return lookup


def _lookup(coords, valid, grid_zyx, qcoords, qok):
    """Rows (int64, -1 where empty) of the (B, V) sites for a (K, B, Q)
    block of queries at once (``_lookup_fn``)."""
    return _lookup_fn(coords, valid, grid_zyx)(qcoords, qok)


def batched_subm_rulebook(coords, valid, grid_zyx, kernel: int = 3):
    """(B, K3, V) neighbour rows of a submanifold conv at each scene's sites.

    Sites and queries are the same set, so the relation is antisymmetric:
    nidx[K3-1-t][j] = i iff nidx[t][i] = j.  Only the first K3//2 + 1 taps
    (the centre included) are probed; the mirror taps come from one scatter
    of those, which never collides (keys are unique a site)."""
    b, v = valid.shape
    r = kernel // 2
    offs = _cube((-r,) * 3, (r + 1,) * 3, coords.device)
    k3 = offs.shape[0]
    h = k3 // 2 + 1
    nc = coords.to(torch.int64)[None] + offs[:h, None, None]  # (h, B, V, 3)
    nidx = _lookup(coords, valid, grid_zyx, nc, _in_grid(nc, grid_zyx, valid[None]))
    nidx = nidx.transpose(0, 1)  # (B, h, V)
    rows = torch.where(nidx[:, :h - 1] >= 0, nidx[:, :h - 1], v)
    inv = torch.full((b, h - 1, v + 1), -1, dtype=torch.int64, device=coords.device)
    inv.scatter_(2, rows, torch.arange(v, device=coords.device).expand(b, h - 1, v).contiguous())
    # row j of inv[t] answers tap K3-1-t: taps h..K3-1 in order
    return torch.cat([nidx, inv.flip(1)[..., :v]], dim=1)


def subm_rulebook(coords, valid, grid_zyx, kernel: int = 3):
    """(K3, V) rulebook of one scene (``batched_subm_rulebook``)."""
    return batched_subm_rulebook(coords[None], valid[None], grid_zyx, kernel)[0]


def _patches(features, valid, nidx):
    """(Q, K3*Cin) im2col patches of a (K3, Q) rulebook over (V, Cin)
    masked features, empty taps reading a zero row."""
    v, cin = features.shape
    k3, q = nidx.shape
    x = features * valid[:, None].to(features.dtype)
    x = torch.cat([x, x.new_zeros((1, cin))], dim=0)
    # a contiguous (Q, K3) index: the gather then writes (Q, K3, Cin) in order
    rows = torch.where(nidx >= 0, nidx, v).t().contiguous()
    return x[rows].reshape(q, k3 * cin)


class Im2colGEMM(torch.autograd.Function):
    """im2col + wide GEMM with a gather-only backward.  ``back`` (U, V)
    holds, for each input row, the flat (output * K3 + tap) rows of the
    patch matrix that read it (-1: none): dfeatures[i] = sum_u
    dpatches[back[u, i]].  dW = patches^T @ dy from recomputed patches
    (nothing of the patch matrix is saved)."""

    @staticmethod
    def forward(ctx, features, valid, nidx, back, weights):
        ctx.save_for_backward(features, valid, nidx, back, weights)
        k3, cin, cout = weights.shape
        return _patches(features, valid, nidx) @ weights.reshape(k3 * cin, cout)

    @staticmethod
    def backward(ctx, dy):
        features, valid, nidx, back, weights = ctx.saved_tensors
        k3, cin, cout = weights.shape
        q = nidx.shape[1]
        dfeat = dw = None
        if ctx.needs_input_grad[4]:
            dw = (_patches(features, valid, nidx).t() @ dy).reshape(weights.shape)
        if ctx.needs_input_grad[0]:
            dpat = (dy @ weights.reshape(k3 * cin, cout).t()).reshape(q * k3, cin)
            dpat = torch.cat([dpat, dpat.new_zeros((1, cin))], dim=0)  # row q*k3: zero
            dfeat = dpat[torch.where(back >= 0, back, q * k3)].sum(dim=0)
            dfeat = dfeat * valid[:, None].to(dfeat.dtype)
        return dfeat, None, None, None, dw


def _mirror_back(nidx):
    """The ``back`` table of a submanifold rulebook: input j is read by
    output nidx[K3-1-t, j] at tap t (the mirrored rulebook)."""
    k3 = nidx.shape[0]
    mirror = nidx.flip(0)
    taps = torch.arange(k3, device=nidx.device)[:, None]
    return torch.where(mirror >= 0, mirror * k3 + taps, -1)


def _batch_rows(nidx, v):
    """(B, K3, Q) rows of each scene -> (K3, B*Q) rows of the (B*V, C)
    stacked scenes, -1 (empty) kept."""
    base = (torch.arange(nidx.shape[0], device=nidx.device) * v)[:, None, None]
    rows = torch.where(nidx >= 0, nidx + base, -1)
    return rows.transpose(0, 1).reshape(nidx.shape[1], -1)


def batched_subm_conv3d(features, valid, nidx, weights):
    """Submanifold conv of a batch over its (B, K3, V) rulebooks: (B, V, Cin)
    -> (B, V, Cout), zero at invalid sites; one GEMM over the stacked
    scenes."""
    b, v, cin = features.shape
    rows = _batch_rows(nidx, v)
    out = Im2colGEMM.apply(features.reshape(b * v, cin), valid.reshape(b * v), rows,
                           _mirror_back(rows), weights)
    return out.reshape(b, v, -1) * valid[..., None].to(out.dtype)


def submanifold_conv3d(features, coords, valid, weights, grid_zyx, kernel=3, nidx=None):
    """SubMConv3d of one scene: outputs at the input sites only
    (``_submanifold_conv3d_v2``)."""
    if nidx is None:
        nidx = subm_rulebook(coords, valid, grid_zyx, kernel)
    return batched_subm_conv3d(features[None], valid[None], nidx[None], weights)[0]


def _candidates(coords, valid, stride, ker, pd, dgrid):
    """Every output site whose window covers each input site: on an axis
    output o covers input i iff s*o - p <= i <= s*o - p + k - 1, so o runs
    from ceil((i + p - k + 1) / s) to floor((i + p) / s) (floor division of
    negative numbers floors, as the JAX package's ``//``).  Returns the
    candidates (C, B, V, 3) and their validity (C, B, V), C = prod((k-1)//s
    + 1)."""
    c = coords.to(torch.int64)
    o_hi = torch.stack([torch.div(c[..., a] + pd[a], stride[a], rounding_mode="floor")
                        for a in range(3)], dim=-1)
    o_lo = torch.stack([-torch.div(-(c[..., a] + pd[a] - ker[a] + 1), stride[a],
                                   rounding_mode="floor") for a in range(3)], dim=-1)
    steps = _cube((0, 0, 0), [((ker[a] - 1) // stride[a]) + 1 for a in range(3)], coords.device)
    o = o_hi[None] - steps[:, None, None]  # (C, B, V, 3)
    ok = _in_grid(o, dgrid, valid[None]) & (o >= o_lo[None]).all(dim=-1)
    return o, ok


def downsampled_grid(grid_zyx, stride, kernel=3, pad=1):
    """spconv's output extent (g + 2p - k) // s + 1 an axis."""
    stride, ker, pd = _triple(stride), _triple(kernel), _triple(pad)
    return tuple((int(grid_zyx[a]) + 2 * pd[a] - ker[a]) // stride[a] + 1 for a in range(3))


def batched_downsample_sites(coords, valid, stride_zyx, out_cap: int, grid_zyx, kernel=3, pad=1):
    """Each scene's unique SparseConv3d output sites, padded to ``out_cap``:
    every site whose window touches an occupied input (spconv's
    odd-coordinate halo included).  Past ``out_cap`` a scene's sites are
    dropped in key order.  Returns (out_coords (B, out_cap, 3) int64, zero
    where invalid; out_valid (B, out_cap); the output grid)."""
    stride, ker, pd = _triple(stride_zyx), _triple(kernel), _triple(pad)
    dgrid = downsampled_grid(grid_zyx, stride, ker, pd)
    nb = valid.shape[0]
    cand, ok = _candidates(coords, valid, stride, ker, pd, dgrid)
    cells = dgrid[0] * dgrid[1] * dgrid[2]
    skeys = torch.sort(_scene_keys(cand.transpose(0, 1), dgrid, ok.transpose(0, 1))
                       .reshape(-1)).values
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[1:] = skeys[1:] != skeys[:-1]
    first &= skeys != _KEY_SENTINEL
    scene = torch.where(first, skeys // cells, nb)
    # a scene's unique rank: the global rank less the uniques of the scenes
    # before it, read where the scene's keys start in the sorted order
    seen = torch.cumsum(first, 0)
    starts = torch.searchsorted(skeys, torch.arange(nb + 1, device=coords.device) * cells)
    before = torch.where(starts > 0, seen[(starts - 1).clamp(min=0)], 0)
    rank = seen - 1 - before[scene]
    keep = first & (rank < out_cap)  # no mode="drop" in torch: the cap by hand
    slot = torch.where(keep, scene * (out_cap + 1) + rank, nb * (out_cap + 1))
    ukeys = torch.full((nb * (out_cap + 1) + 1,), -1, dtype=torch.int64, device=coords.device)
    ukeys.scatter_(0, slot, skeys - scene.clamp(max=nb - 1) * cells)
    ukeys = ukeys[:-1].view(nb, out_cap + 1)[:, :out_cap]
    out_valid = ukeys >= 0
    _, nyk, nxk = dgrid
    safe = ukeys.clamp(min=0)
    out_coords = torch.stack([safe // (nyk * nxk), (safe // nxk) % nyk, safe % nxk], dim=-1)
    return out_coords, out_valid, dgrid


def downsample_sites(coords, valid, stride_zyx, out_cap: int, grid_zyx, kernel=3, pad=1):
    """``batched_downsample_sites`` of one scene: (out_coords (out_cap, 3),
    out_valid (out_cap,), the output grid)."""
    oc, ov, dgrid = batched_downsample_sites(coords[None], valid[None], stride_zyx, out_cap,
                                             grid_zyx, kernel, pad)
    return oc[0], ov[0], dgrid


def _strided_rulebook_outprobe(coords, valid, out_coords, out_valid, dgrid, stride, ker, pd):
    """(B, K3, O) strided rulebooks built from the input side: each input
    site probes the output table for the <= prod(ceil(k/s)) outputs covering
    it, derives the tap t = i - s*o + p of each hit and writes nidx[t, o] =
    i.  The (t, o) pairs are unique, so writes never collide; outputs
    dropped by the cap receive no writes.  Also returns the hits from the
    input side, (B, C, V) flat o * K3 + t or -1: the backward's table."""
    nb, v = valid.shape
    o_cap = out_coords.shape[1]
    k3 = ker[0] * ker[1] * ker[2]
    q_o, q_ok = _candidates(coords, valid, stride, ker, pd, dgrid)  # (C, B, V)
    j = _lookup(out_coords, out_valid, dgrid, q_o, q_ok)
    c = coords.to(torch.int64)[None]
    t_off = [c[..., a] - q_o[..., a] * stride[a] + pd[a] for a in range(3)]  # each in [0, k)
    t = (t_off[0] * ker[1] + t_off[1]) * ker[2] + t_off[2]
    hit = q_ok & (j >= 0)
    scene = torch.arange(nb, device=coords.device)[None, :, None]
    flat = torch.where(hit, (scene * k3 + t) * (o_cap + 1) + j, nb * k3 * (o_cap + 1))
    src = torch.arange(v, device=coords.device).expand(q_ok.shape)
    nidx = torch.full((nb * k3 * (o_cap + 1) + 1,), -1, dtype=torch.int64, device=coords.device)
    nidx.scatter_(0, flat.reshape(-1), src.reshape(-1))  # the last slot drops the misses
    nidx = nidx[:-1].view(nb, k3, o_cap + 1)[..., :o_cap]
    back = torch.where(hit, j * k3 + t, -1).transpose(0, 1)
    return nidx, back


def batched_strided_rulebook(coords, valid, grid_zyx, out_cap, stride, kernel=3, pad=1):
    """The output sites and rulebooks of a SparseConv3d over a batch:
    (nidx (B, K3, O), back (B, C, V), out_coords (B, O, 3), out_valid
    (B, O), out grid)."""
    stride, ker, pd = _triple(stride), _triple(kernel), _triple(pad)
    oc, ov, dgrid = batched_downsample_sites(coords, valid, stride, out_cap, grid_zyx, ker, pd)
    nidx, back = _strided_rulebook_outprobe(coords, valid, oc, ov, dgrid, stride, ker, pd)
    return nidx, back, oc, ov, dgrid


def strided_rulebook(coords, valid, grid_zyx, out_cap, stride=(2, 2, 2), kernel=3, pad=1):
    """One scene's (nidx (K3, O), out_coords, out_valid, out grid)."""
    nidx, _, oc, ov, dgrid = batched_strided_rulebook(coords[None], valid[None], grid_zyx,
                                                      out_cap, stride, kernel, pad)
    return nidx[0], oc[0], ov[0], dgrid


def batched_gather_conv3d(features, valid, nidx, back, out_valid, weights):
    """A strided conv of a batch over its (B, K3, O) rulebooks and (B, C, V)
    backward tables: (B, V, Cin) -> (B, O, Cout), zero at invalid
    outputs."""
    b, v, cin = features.shape
    k3, o = nidx.shape[1:]
    base = (torch.arange(b, device=back.device) * (o * k3))[:, None, None]
    back = torch.where(back >= 0, back + base, -1).transpose(0, 1).reshape(back.shape[1], -1)
    out = Im2colGEMM.apply(features.reshape(b * v, cin), valid.reshape(b * v),
                           _batch_rows(nidx, v), back, weights)
    return out.reshape(b, o, -1) * out_valid[..., None].to(out.dtype)


def strided_conv3d(features, coords, valid, weights, grid_zyx, out_cap, stride=(2, 2, 2),
                   kernel=3, pad=1):
    """SparseConv3d of one scene (``_strided_conv3d_v2``): an output at every
    site whose window touches an occupied input; each output gathers its
    footprint in = s*out + j - p.  Returns (out, out_coords, out_valid, out
    grid)."""
    nidx, back, oc, ov, dgrid = batched_strided_rulebook(coords[None], valid[None], grid_zyx,
                                                         out_cap, stride, kernel, pad)
    out = batched_gather_conv3d(features[None], valid[None], nidx, back, ov, weights)
    return out[0], oc[0], ov[0], dgrid


def batched_scatter_to_dense(features, coords, valid, grid_zyx):
    """(B, V, C) sparse -> (B, D, H, W, C) dense."""
    nz, ny, nx = _dims(grid_zyx)
    b, _, c = features.shape
    drop = b * nz * ny * nx
    safe = torch.where(valid, _scene_keys(coords, grid_zyx, valid), drop).reshape(-1)
    x = (features * valid[..., None].to(features.dtype)).reshape(-1, c)
    canvas = features.new_zeros((drop + 1, c)).index_add(0, safe, x)
    return canvas[:-1].reshape(b, nz, ny, nx, c)


def scatter_to_dense(features, coords, valid, grid_zyx):
    """(V, C) sparse -> (D, H, W, C) dense (for HeightCompression)."""
    return batched_scatter_to_dense(features[None], coords[None], valid[None], grid_zyx)[0]


def inverse_offsets(kernel=3, pad=1) -> np.ndarray:
    """(K3, 3) per-axis offsets j - p, j in [0, k), row-major (dz, dy, dx):
    the transpose of the strided conv's in = s * out + j - p rulebook (the
    JAX package's ``_inv_offsets``)."""
    ker, pd = _triple(kernel), _triple(pad)
    return np.stack(np.meshgrid(*[np.arange(k) - p for k, p in zip(ker, pd)], indexing="ij"),
                    axis=-1).reshape(-1, 3)


def batched_inverse_rulebook(coords, valid, grid_lo, hi_coords, hi_valid, stride=(2, 2, 2),
                             kernel=3, pad=1):
    """The rulebook of a SparseInverseConv3d over a batch: output (high
    resolution) site c reads low-resolution site (c - off) // s at the tap
    of offset off wherever c - off is divisible by the stride (floor
    division and remainder, as the JAX package's ``//`` and ``%``).  ``pad``
    must be the downsampling conv's.  Returns (nidx (B, K3, H) rows of the
    (B, V) low-resolution sites or -1; back (K3, B * V) flat rows (b * H +
    c) * K3 + t of the patch matrix reading each low-resolution row, or -1:
    for a tap, c -> (c - off) // s is one to one, so each row is read at
    most once a tap)."""
    nb, v = valid.shape
    h = hi_valid.shape[1]
    s = torch.as_tensor(_triple(stride), device=coords.device)
    offs = torch.as_tensor(inverse_offsets(kernel, pad), device=coords.device)
    k3 = offs.shape[0]
    shifted = hi_coords.to(torch.int64)[None] - offs[:, None, None]  # (K3, B, H, 3)
    divisible = (torch.remainder(shifted, s) == 0).all(dim=-1)
    lo = torch.div(shifted, s, rounding_mode="floor")
    nidx = _lookup(coords, valid, grid_lo, lo, _in_grid(lo, grid_lo, divisible & hi_valid[None]))
    nidx = nidx.transpose(0, 1)  # (B, K3, H)
    tap = torch.arange(k3, device=coords.device)[None, :, None]
    scene = torch.arange(nb, device=coords.device)[:, None, None]
    flat = (scene * h + torch.arange(h, device=coords.device)) * k3 + tap  # (B, K3, H)
    drop = k3 * nb * v
    dst = torch.where(nidx >= 0, tap * (nb * v) + scene * v + nidx, drop)
    back = torch.full((drop + 1,), -1, dtype=torch.int64, device=coords.device)
    back.scatter_(0, dst.reshape(-1), flat.reshape(-1))
    return nidx, back[:-1].view(k3, nb * v)


def batched_inverse_conv3d(features, coords, valid, weights, hi_coords, hi_valid, grid_lo,
                           stride=(2, 2, 2), kernel=3, pad=1):
    """SparseInverseConv3d of a batch (the JAX package's
    ``_inverse_conv3d_v2``): (B, V, Cin) low-resolution features -> (B, H,
    Cout) at the high-resolution sites, zero where ``hi_valid`` is false;
    one gather and GEMM over the stacked scenes, a gather-only backward."""
    b, v, cin = features.shape
    nidx, back = batched_inverse_rulebook(coords, valid, grid_lo, hi_coords, hi_valid, stride,
                                          kernel, pad)
    out = Im2colGEMM.apply(features.reshape(b * v, cin), valid.reshape(b * v),
                           _batch_rows(nidx, v), back, weights)
    return out.reshape(b, hi_valid.shape[1], -1) * hi_valid[..., None].to(out.dtype)


def inverse_conv3d(features, coords, valid, weights, hi_coords, hi_valid, grid_lo,
                   stride=(2, 2, 2), kernel=3, pad=1):
    """SparseInverseConv3d of one scene (the JAX package's
    ``inverse_conv3d``): (V, Cin) -> (H, Cout)."""
    return batched_inverse_conv3d(features[None], coords[None], valid[None], weights,
                                  hi_coords[None], hi_valid[None], grid_lo, stride, kernel,
                                  pad)[0]


def query_offsets(max_range: int, radius_vox: float = 4.0, cell_zyx=None,
                  radius_world: float | None = None) -> np.ndarray:
    """(K, 3) zyx offsets a voxel query walks, nearest first (a stable sort
    by distance): with ``cell_zyx`` and ``radius_world`` those whose nearest
    possible centre, (|off| - 1) cells an axis, lies within the radius;
    else those within ``radius_vox`` cells."""
    r = int(max_range)
    offs = np.stack(np.meshgrid(*([np.arange(-r, r + 1)] * 3), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    if cell_zyx is not None and radius_world is not None:
        cell = np.asarray(cell_zyx, np.float64)
        dmin2 = (((np.maximum(np.abs(offs) - 1, 0)) * cell) ** 2).sum(1)
        keep = dmin2 <= float(radius_world) ** 2
        d2 = ((offs * cell) ** 2).sum(1)
    else:
        d2 = (offs ** 2).sum(1)
        keep = d2 <= radius_vox * radius_vox
    return offs[keep][np.argsort(d2[keep], kind="stable")]


def batched_voxel_query(query_vox, coords, valid, grid_zyx, max_range: int = 4,
                        radius_vox: float = 4.0, nsample: int = 16, cell_zyx=None,
                        radius_world: float | None = None, chunk: int = 128):
    """Voxel neighbourhood query of a batch (pointnet2_stack
    voxel_query_utils, Voxel-RCNN's grid pooling): for each of the (B, S, 3)
    float zyx voxel-space queries, the first ``nsample`` occupied sites of
    its scene, in ``query_offsets`` order around the query's base cell.

    With ``cell_zyx`` (the world size of a cell, z, y, x) and
    ``radius_world`` a site counts when its centre lies within the radius
    of the query point in world units, from the floored base cell; else
    within ``radius_vox`` cells of the rounded base cell.  The offsets are
    looked up ``chunk`` at a time as a (B, S, chunk) hit mask; a running
    count carried across chunks gives each hit its slot, as the JAX
    package's scan over the offsets fills them.

    Returns idx (B, S, nsample) int64 rows of ``coords``, the unfilled slots
    repeating slot 0 (0 for an empty ball); empty (B, S) bool; slot_valid
    (B, S, nsample), the slots holding real hits."""
    b, s, _ = query_vox.shape
    dev = query_vox.device
    metric = cell_zyx is not None and radius_world is not None
    offs = torch.as_tensor(query_offsets(max_range, radius_vox, cell_zyx, radius_world),
                           device=dev)
    base = (torch.floor(query_vox) if metric else torch.round(query_vox)).to(torch.int64)
    if metric:
        cell = torch.tensor(cell_zyx, dtype=query_vox.dtype, device=dev)
        r2 = float(radius_world) ** 2
    lookup = _lookup_fn(coords, valid, grid_zyx)
    cnt = torch.zeros((b, s), dtype=torch.int64, device=dev)
    buf = torch.zeros((b, s, nsample + 1), dtype=torch.int64, device=dev)  # last: dropped hits
    for c0 in range(0, offs.shape[0], chunk):
        nc = base[:, :, None, :] + offs[c0:c0 + chunk]  # (B, S, C, 3)
        q = nc.permute(2, 0, 1, 3)  # (C, B, S, 3)
        nidx = lookup(q, _in_grid(q, grid_zyx, torch.ones_like(q[..., 0], dtype=torch.bool)))
        hit = (nidx >= 0).permute(1, 2, 0)  # (B, S, C)
        if metric:
            rel = (nc.to(query_vox.dtype) + 0.5 - query_vox[:, :, None, :]) * cell
            hit &= (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
                    + rel[..., 2] * rel[..., 2]) <= r2
        slot = cnt[..., None] + torch.cumsum(hit, dim=-1) - 1
        dst = torch.where(hit & (slot < nsample), slot, nsample)
        buf.scatter_(2, dst, nidx.permute(1, 2, 0))
        cnt = torch.clamp(cnt + hit.sum(-1), max=nsample)
    buf = buf[..., :nsample]
    lane = torch.arange(nsample, device=dev)
    filled = lane < torch.clamp(cnt, min=1)[..., None]
    idx = torch.where(filled, buf, buf[..., :1])
    return idx, cnt == 0, lane < cnt[..., None]


def voxel_query(query_vox, coords, valid, grid_zyx, max_range: int = 4, radius_vox: float = 4.0,
                nsample: int = 16, cell_zyx=None, radius_world: float | None = None):
    """``batched_voxel_query`` of one scene: (S, 3) queries -> (idx (S,
    nsample), empty (S,), slot_valid (S, nsample))."""
    idx, empty, slot = batched_voxel_query(query_vox[None], coords[None], valid[None], grid_zyx,
                                           max_range, radius_vox, nsample, cell_zyx,
                                           radius_world)
    return idx[0], empty[0], slot[0]


def focal_split_and_spawn(feats, coords, valid, imps, grid_zyx, threshold: float,
                          spawn_cap: int, mask_multi: bool = False):
    """The focal sparse conv's split and spawn over a batch
    (``com_tpu/ops/sparse.py`` ``focal_split_and_spawn``, vmapped there;
    focal_sparse_conv.py _gen_sparse_features): feats (B, V, C), coords
    (B, V, 3), valid (B, V), imps (B, V, 27) importance logits (26 neighbour
    offsets in the row-major cube order less the centre, then the voxel's
    own).  A valid voxel whose own sigmoid passes ``threshold`` is
    foreground and is scaled by it (by it and its validity, for every
    voxel, with ``mask_multi``); each foreground voxel spawns a voxel at
    each in-grid neighbour offset whose sigmoid passes the threshold and
    that no voxel of the scene holds, carrying its features times that
    score.  Spawns at one cell keep the highest score (equal scores: the
    lowest parent row, then offset), and a scene keeps its ``spawn_cap``
    highest (equal: the lower cell key), as the JAX package's sort on (key,
    -score) and ``top_k``.  Returns (feats (B, V + cap, C), coords, valid,
    own (B, V)); an unused spawn slot is invalid with coords -1."""
    b, v, c = feats.shape
    own = torch.sigmoid(imps[..., -1])
    fg = (own > threshold) & valid
    if mask_multi:
        base = feats * (own * valid.to(own.dtype))[..., None]
    else:
        base = feats * torch.where(fg, own, torch.ones_like(own))[..., None]
    cube = _cube((-1, -1, -1), (2, 2, 2), coords.device)
    offs = torch.cat([cube[:13], cube[14:]])  # 26 neighbours, the centre removed
    k = offs.shape[0]
    cand = (coords.to(torch.int64)[:, :, None, :] + offs).reshape(b, v * k, 3)
    score = torch.sigmoid(imps[..., :k]).reshape(b, v * k)
    ok = ((score > threshold) & fg.repeat_interleave(k, dim=1)
          & _in_grid(cand, grid_zyx, torch.ones_like(score, dtype=torch.bool)))
    exists = _lookup(coords, valid, grid_zyx, cand[None], ok[None])[0] >= 0
    ok = ok & ~exists
    flat_score = torch.where(ok, score, torch.zeros_like(score))
    keys = flat_key(cand, grid_zyx, ok)  # the sentinel where not a candidate
    # lexicographic (key, -score, row) by two stable sorts: the first of each
    # key's run is its best spawn
    by_score = torch.argsort(-flat_score.detach(), dim=1, stable=True)
    order = torch.gather(by_score, 1, torch.argsort(torch.gather(keys, 1, by_score), dim=1,
                                                    stable=True))
    skeys = torch.gather(keys, 1, order)
    first = torch.ones_like(skeys, dtype=torch.bool)
    first[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    first = first & (skeys != _KEY_SENTINEL)
    uniq = torch.where(first, torch.gather(flat_score.detach(), 1, order),
                       torch.full_like(flat_score, -1.0))
    top = torch.argsort(-uniq, dim=1, stable=True)[:, :spawn_cap]  # lax.top_k's order
    sel = torch.gather(order, 1, top)
    sel_valid = torch.gather(uniq, 1, top) > 0
    sel_score = torch.where(sel_valid, torch.gather(flat_score, 1, sel),
                            torch.zeros_like(sel, dtype=flat_score.dtype))
    parent = sel // k
    spawn_feats = torch.gather(feats, 1, parent[..., None].expand(-1, -1, c)) \
        * sel_score[..., None].to(feats.dtype)
    spawn_coords = torch.gather(cand, 1, sel[..., None].expand(-1, -1, 3)).to(coords.dtype)
    spawn_coords = torch.where(sel_valid[..., None], spawn_coords, torch.full_like(spawn_coords,
                                                                                   -1))
    out_coords = torch.cat([torch.where(valid[..., None], coords, torch.full_like(coords, -1)),
                            spawn_coords], dim=1)
    return (torch.cat([base, spawn_feats], dim=1), out_coords,
            torch.cat([valid, sel_valid], dim=1), own)
