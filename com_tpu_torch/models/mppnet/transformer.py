"""MPPNet's transformer stack (counterpart of ``com_tpu/models/mppnet/
transformer.py``; pcdet model_utils/mppnet_utils.py).

* ``MLP``: ReLU MLP, ``layers.{i}`` (mppnet_utils.py:96-107).
* ``FFN``: the residual feed-forward merge (mppnet_utils.py:377-402).
* ``SpatialMixerBlock``: MLP-mixer along each axis of the proxy-point grid
  (mppnet_utils.py:109-153).
* ``MPPNetEncoderLayer``: a group's token attends to its proxy points,
  then (but in the last layer) the groups' proxies fuse and cross-attend
  (mppnet_utils.py:264-365, forward_post).
* ``MPPNetTransformer``: the grouped encoder with a learned token a group
  (mppnet_utils.py:155-239).
* ``PointNetFeat`` and ``SeqBoxEmbed``: the PointNet over the trajectory's
  box sequence (mppnet_utils.py:11-94).

Groups are a leading axis (G, B', L, C), as in the JAX package.  Module
names mirror its flax scopes (pcdet's importer has no table for this
head): ``MultiHeadDotProductAttention_0`` is ``self_attn``, the layer's
``Dense_1`` / ``Dense_0`` are ``linear1`` / ``linear2`` and its
``LayerNorm_{0,1}`` ``norm{1,2}``.  Attention is written out as the JAX
package's is: projections, query over sqrt(head width), product, softmax,
product, output projection.  Layer norms take flax's eps 1e-6; dropout runs
only in training, from ``generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..layers import BatchNorm

LN_EPS = 1e-6  # flax's nn.LayerNorm


def _dropout(x, p, training, generator=None):
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


class LayerNorm(nn.LayerNorm):
    def __init__(self, c):
        super().__init__(c, eps=LN_EPS)


class MLP(nn.Module):
    """``num_layers`` linears, ReLU between them."""

    def __init__(self, cin: int, hidden: int, cout: int, num_layers: int):
        super().__init__()
        dims = [cin] + [hidden] * (num_layers - 1) + [cout]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


class Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` over (B, L, C): ``query``,
    ``key``, ``value`` and ``out`` (C -> C, with bias)."""

    def __init__(self, c: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.nhead, self.dropout = nhead, dropout
        self.query, self.key, self.value, self.out = (nn.Linear(c, c) for _ in range(4))

    def forward(self, q, k, v, generator=None):
        b, lq, c = q.shape
        h, d = self.nhead, c // self.nhead
        qh = self.query(q).reshape(b, lq, h, d) / math.sqrt(d)
        kh = self.key(k).reshape(b, -1, h, d)
        vh = self.value(v).reshape(b, -1, h, d)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
        w = _dropout(w, self.dropout, self.training, generator)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(b, lq, c))


class FFN(nn.Module):
    """tgt + input -> norm1 -> + linear2(relu(linear1)) -> norm2 (flax's
    ``FFN``: ``Dense_1`` is ``linear1``, ``Dense_0`` ``linear2``)."""

    def __init__(self, d_model: int, dim_feedforward: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1, self.norm2 = LayerNorm(d_model), LayerNorm(d_model)

    def forward(self, tgt, tgt_input, generator=None):
        drop = lambda x: _dropout(x, self.dropout, self.training, generator)  # noqa: E731
        tgt = self.norm1(tgt + drop(tgt_input))
        tgt2 = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm2(tgt + drop(tgt2))


class SpatialMixerBlock(nn.Module):
    """Per grid axis x, y, z an MLP over that axis (``mixer_{a}``) and a
    norm (``mixer_{a}_norm``) on the residual, then the channel FFN
    (``linear1`` C -> 2C, ReLU, ``linear2`` 2C -> C) and ``norm``.  src
    (B', g^3, C), the grid flattened x-major."""

    AXES = ("x", "y", "z")

    def __init__(self, hidden: int, grid_size: int, channels: int, dropout: float = 0.0):
        super().__init__()
        self.grid_size, self.dropout = grid_size, dropout
        for a in self.AXES:
            setattr(self, f"mixer_{a}", MLP(grid_size, hidden, grid_size, 3))
            setattr(self, f"mixer_{a}_norm", LayerNorm(channels))
        self.linear1 = nn.Linear(channels, 2 * channels)
        self.linear2 = nn.Linear(2 * channels, channels)
        self.norm = LayerNorm(channels)

    def forward(self, src, generator=None):
        bsz, g3, c = src.shape
        g = self.grid_size
        x = src.reshape(bsz, g, g, g, c)
        for axis, a in enumerate(self.AXES, start=1):
            mixed = getattr(self, f"mixer_{a}")(x.movedim(axis, -1)).movedim(-1, axis)
            x = getattr(self, f"mixer_{a}_norm")(x + mixed)
        x = x.reshape(bsz, g3, c)
        f = self.linear2(_dropout(torch.relu(self.linear1(x)), self.dropout, self.training,
                                  generator))
        return self.norm(x + f)


class MPPNetEncoderLayer(nn.Module):
    """One grouped layer over src (G, B', 1 + P, C): the proxies mixed, the
    token's attention over them (``self_attn``, keys with ``pos``), its
    residual norms and FFN; but in the last layer the groups' proxies
    concatenated through ``fusion_all_groups`` and each group's
    cross-attention to the fusion (``cross_attn_{i}``) through the shared
    ``ffn``.  Returns (src, the tokens (G, B', C))."""

    def __init__(self, d_model, nhead, num_groups, dim_feedforward, mixer_hidden, grid_size,
                 last_layer, dropout=0.1):
        super().__init__()
        self.num_groups, self.last_layer, self.dropout = num_groups, last_layer, dropout
        self.mixer = SpatialMixerBlock(mixer_hidden, grid_size, d_model, dropout)
        self.self_attn = Attention(d_model, nhead, dropout)
        self.norm1, self.norm2 = LayerNorm(d_model), LayerNorm(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        if not last_layer:
            self.fusion_all_groups = MLP(num_groups * d_model, d_model, d_model, 4)
            self.ffn = FFN(d_model, dim_feedforward, dropout)
            self.cross_attn = nn.ModuleList(Attention(d_model, nhead, dropout)
                                            for _ in range(num_groups))

    def forward(self, src, pos=None, generator=None):
        g, bsz, length, c = src.shape
        p = length - 1
        drop = lambda x: _dropout(x, self.dropout, self.training, generator)  # noqa: E731
        proxy = self.mixer(src[:, :, 1:].reshape(g * bsz, p, c), generator).reshape(g, bsz, p, c)
        token = src[:, :, :1]
        key = proxy if pos is None else proxy + pos[None, None, 1:]
        summary = self.self_attn(token.reshape(g * bsz, 1, c), key.reshape(g * bsz, p, c),
                                 proxy.reshape(g * bsz, p, c), generator).reshape(g, bsz, 1, c)
        token = self.norm1(token + drop(summary))
        token = self.norm2(token + drop(self.linear2(drop(torch.relu(self.linear1(token))))))
        if not self.last_layer:
            fused = self.fusion_all_groups(torch.cat(list(proxy), dim=-1))  # (B', P, C)
            fkey = fused if pos is None else fused + pos[None, 1:]
            groups = []
            for i in range(self.num_groups):
                q = proxy[i] if pos is None else proxy[i] + pos[None, 1:]
                cross = self.cross_attn[i](q, fkey, fused, generator)
                groups.append(self.ffn(proxy[i], cross, generator))
            proxy = torch.stack(groups, dim=0)
        return torch.cat([token, proxy], dim=2), token[:, :, 0]


class MPPNetTransformer(nn.Module):
    """The grouped encoder over src (B', F * P, C), frame-major proxy
    features.  Four frames or fewer: a group a frame; more: each group's
    frames (strided by ``sequence_stride``, else consecutive) concatenated
    through ``fusion_all_group`` and merged by ``fusion_norm`` (an FFN).
    Returns hs (G, B', C), the last layer's tokens, and every layer's."""

    def __init__(self, d_model, nhead, num_encoder_layers, dim_feedforward, num_proxy_points,
                 num_groups, num_frames, sequence_stride=1, mixer_hidden=16, grid_size=4,
                 dropout=0.1):
        super().__init__()
        self.p, self.g, self.num_frames = num_proxy_points, num_groups, num_frames
        self.sequence_stride = sequence_stride
        if num_frames > 4:
            group_length = num_frames // num_groups
            self.fusion_all_group = MLP(group_length * d_model, d_model, d_model, 4)
            self.fusion_norm = FFN(d_model, dim_feedforward, dropout)
        self.token = nn.Parameter(torch.zeros(num_groups, 1, d_model))
        self.layers = nn.ModuleList(
            MPPNetEncoderLayer(d_model, nhead, num_groups, dim_feedforward, mixer_hidden,
                               grid_size, li == num_encoder_layers - 1, dropout)
            for li in range(num_encoder_layers))

    def forward(self, src, pos=None, generator=None):
        bsz, _, c = src.shape
        p, g = self.p, self.g
        if self.num_frames > 4:
            gl = self.num_frames // g
            frames = [[(i + j * self.sequence_stride) if self.sequence_stride > 1
                       else (i * gl + j) for j in range(gl)] for i in range(g)]
            groups = torch.stack([torch.cat([src[:, f * p:(f + 1) * p] for f in fr], dim=-1)
                                  for fr in frames], dim=0)  # (G, B', P, gl * C)
            merged = self.fusion_all_group(groups.reshape(g * bsz, p, -1))
            base = src[:, :g * p].reshape(bsz, g, p, c).transpose(0, 1).reshape(g * bsz, p, c)
            grouped = self.fusion_norm(base, merged, generator).reshape(g, bsz, p, c)
        else:
            grouped = src.reshape(bsz, g, p, c).transpose(0, 1)
        tokens = self.token[:, None].expand(g, bsz, 1, c)
        x = torch.cat([tokens, grouped], dim=2)
        token_list = []
        for layer in self.layers:
            x, tok = layer(x, pos, generator)
            token_list.append(tok)
        return x[:, :, 0], token_list


class BoxNorm(BatchNorm):
    """flax's ``nn.BatchNorm`` of the box-sequence PointNet: eps 1e-5,
    momentum 0.9."""

    MOMENTUM = 0.9

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)


class PointNetFeat(nn.Module):
    """Linear + norm 8 -> 64 -> 128 -> 256 -> ``output_channel`` over (B', L,
    Cin), ReLU but after the last; returns (the max over L, every row)."""

    def __init__(self, cin: int = 8, output_channel: int = 512):
        super().__init__()
        dims = [cin, 64, 128, 256, output_channel]
        self.fcs = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.bns = nn.ModuleList(BoxNorm(b) for b in dims[1:])

    def forward(self, x):
        for i, (fc, bn) in enumerate(zip(self.fcs, self.bns)):
            x = bn(fc(x))
            if i < len(self.fcs) - 1:
                x = torch.relu(x)
        return x.max(dim=1).values, x


class SeqBoxEmbed(nn.Module):
    """The PointNet over the canonical box sequence (B', F, 8): ``pre_bn``,
    ``feat`` (PointNetFeat to 512), ``fc1`` / ``bn1`` (512 -> 256), ``fc2``
    / ``bn2`` (-> channels); the auxiliary box residual from ``{center,
    size,heading}_hidden`` + ``..._out`` (no bias).  Returns (residual (B',
    7), feature (B', channels))."""

    def __init__(self, channels: int):
        super().__init__()
        self.pre_bn = BoxNorm(8)
        self.feat = PointNetFeat(8, 512)
        self.fc1, self.bn1 = nn.Linear(512, 256), BoxNorm(256)
        self.fc2, self.bn2 = nn.Linear(256, channels), BoxNorm(channels)
        for name, n in (("center", 3), ("size", 3), ("heading", 1)):
            setattr(self, f"{name}_hidden", nn.Linear(channels, 256))
            setattr(self, f"{name}_out", nn.Linear(256, n, bias=False))

    def forward(self, box_seq):
        x, _ = self.feat(self.pre_bn(box_seq))
        x = torch.relu(self.bn1(self.fc1(x)))
        feat = torch.relu(self.bn2(self.fc2(x)))
        res = [getattr(self, f"{n}_out")(torch.relu(getattr(self, f"{n}_hidden")(feat)))
               for n in ("center", "size", "heading")]
        return torch.cat(res, dim=-1), feat
