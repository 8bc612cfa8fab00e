"""Weight bridge: the JAX package's flax variables -> the port's modules.

The port names its parameters as pcdet does, so this is the inverse of the
rules the JAX package uses to import a pcdet state_dict (its
``utils/torch_import.py``), written again here: for each pcdet key, the flax
leaf it came from and the layout change back to PyTorch.

    flax Dense (in, out)              -> Linear (out, in)
    flax Conv (kH, kW, I, O)          -> Conv2d (O, I, kH, kW)
    flax ConvTranspose (kH, kW, I, O) -> ConvTranspose2d (I, O, kH, kW),
                                         spatially flipped
    BN scale/bias, mean/var           -> weight/bias, running_mean/var

    sparse conv (K3, I, O)            -> spconv 2.x (O, kz, ky, kx, I)

The 1x1 stride-1 deblock is a plain flax Conv but a pcdet ConvTranspose2d,
so it takes the transposed-conv layout too.  Covers the CenterPoint-Pillar,
PointPillar, CenterPoint-voxel, SECOND, Voxel-RCNN and SECOND-IoU slots:
DynamicPillarVFE, VoxelBackBone8x and VoxelResBackBone8x, BaseBEVBackbone,
CenterHead, AnchorHeadSingle (its 1x1 convs, plain conv layout),
AnchorHeadMulti (its shared and middle ConvBNReLUs and 1x1 convs),
VoxelRCNNHead and SECONDHead (flax Dense (in, out) -> Linear, or Conv1d
(out, in, 1) for SECONDHead; their FC norms' running_var shifted by
1e-3 - 1e-5, ``models/layers.py`` ``BatchNorm1d``), and PV-RCNN's
VoxelSetAbstraction (Conv2d 1x1 (out, in, 1, 1) blocks), PointHeadSimple
and PVRCNNHead (their norms shifted as the RoI heads'), and
PVRCNNPlusPlusHead under its flax names, PointRCNN's PointNet2MSG and
head, and PartA2's UNetV2 (its inverse convs as sparse convs),
PointIntraPartOffsetHead and PartA2FCHead (its pooled-grid convs, dense
flax Conv (kz, ky, kx, I, O) -> spconv 2.x (O, kz, ky, kx, I)), and
MPPNet's heads under their flax names (attention projections (C, H, D) ->
Linear (H * D, C)).  For
comparing a train
step, ``params_from_jax`` maps any tree shaped like flax "params" (its
gradients, its updated parameters) into the same pcdet names, and
``curriculum_state_from_jax`` carries the COMLoss EMA state (either kind)
across and
``sampler_state_from_jax`` the COMAug sampler's confidences;
``train_state_from_jax`` carries a whole JAX checkpoint (weights, Adam's
moments and count, curriculum, sampler) into a port ``TrainState``.
"""
from __future__ import annotations

import numpy as np
import torch

# Each layout change only moves entries (transposes and flips, no scale), so
# it maps Adam's second moment nu as it maps the parameter.
_TRANSFORMS = {
    "copy": lambda a: a,
    "linear": lambda a: a.T,
    "conv2d": lambda a: a.transpose(3, 2, 0, 1),
    "deconv2d": lambda a: a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1],
    "spconv27": lambda a: a.reshape(3, 3, 3, *a.shape[1:]).transpose(4, 0, 1, 2, 3),
    "spconv3": lambda a: a.reshape(3, 1, 1, *a.shape[1:]).transpose(4, 0, 1, 2, 3),
    "conv1d": lambda a: a.T[..., None],
    "conv1x1": lambda a: a.T[..., None, None],
    # flax Conv (kz, ky, kx, I, O) -> spconv 2.x (O, kz, ky, kx, I): PartA2's
    # pooled-grid convs, dense in both packages, pcdet's sparse in layout
    "spconv_dense": lambda a: a.transpose(4, 0, 1, 2, 3),
    # flax MultiHeadDotProductAttention's DenseGeneral projections: query /
    # key / value (C, H, D) -> Linear (H * D, C), their biases (H, D) ->
    # (H * D,), out (H, D, C) -> Linear (C, H * D)
    "mha_in": lambda a: a.reshape(a.shape[0], -1).T,
    "flatten": lambda a: a.reshape(-1),
    "mha_out": lambda a: a.reshape(-1, a.shape[-1]).T,
}
# A running statistic's rule, never a parameter's: the RoI heads'
# BatchNorm1d holds var + (1e-3 - 1e-5) (models/layers.py).
_STAT_TRANSFORMS = {"var_shift": lambda a: a + (1e-3 - 1e-5)}


def _bn(tkey, path, var="copy"):
    """(pcdet key, collection, flax path, transform) for one batch norm."""
    return [(f"{tkey}.weight", "params", (*path, "scale"), "copy"),
            (f"{tkey}.bias", "params", (*path, "bias"), "copy"),
            (f"{tkey}.running_mean", "batch_stats", (*path, "mean"), "copy"),
            (f"{tkey}.running_var", "batch_stats", (*path, "var"), var)]


def _pfn_rules(vfe_cfg, top):
    rules = []
    for i in range(len(vfe_cfg.get("NUM_FILTERS", []))):
        p = (top, f"_PFNLayer_{i}")
        rules.append((f"vfe.pfn_layers.{i}.linear.weight", "params", (*p, "Dense_0", "kernel"),
                      "linear"))
        rules += _bn(f"vfe.pfn_layers.{i}.norm", (*p, "MaskedBatchNorm_0"))
    return rules


def _voxel_backbone_rules(top, residual):
    """pcdet's VoxelBackBone8x names <- the JAX package's stage scopes (the
    inverse of its ``map_voxel_backbone``): conv_input <- subm0_0, conv1.{j}
    <- subm0_{j+1}, conv{s}.0 <- down{s-1} (strided), conv{s}.{1,2} <-
    subm{s-1}_{0,1}, conv_out <- conv_out ((3, 1, 1) kernel).  A plain
    block is ``.0`` conv / ``.1`` norm; a residual block ``.conv{1,2}``
    (with bias) / ``.bn{1,2}``."""
    rules = []

    def block(tkey, scope, transform="spconv27"):
        rules.append((f"{tkey}.0.weight", "params", (top, scope, "kernel"), transform))
        rules.extend(_bn(f"{tkey}.1", (top, scope, "MaskedBatchNorm_0")))

    def resblock(tkey, scope):
        for j in (1, 2):
            p = (top, scope, f"conv{j}")
            rules.append((f"{tkey}.conv{j}.weight", "params", (*p, "kernel"), "spconv27"))
            rules.append((f"{tkey}.conv{j}.bias", "params", (*p, "bias"), "copy"))
            rules.extend(_bn(f"{tkey}.bn{j}", (*p, "MaskedBatchNorm_0")))

    body = resblock if residual else block
    block("backbone_3d.conv_input", "subm0_0")
    for j in range(2 if residual else 1):
        body(f"backbone_3d.conv1.{j}", f"subm0_{j + 1}")
    for s in (2, 3, 4):
        block(f"backbone_3d.conv{s}.0", f"down{s - 1}")
        for j in (1, 2):
            body(f"backbone_3d.conv{s}.{j}", f"subm{s - 1}_{j - 1}")
    block("backbone_3d.conv_out", "conv_out", "spconv3")
    return rules


def _unet_v2_rules(cfg, top):
    """UNetV2's pcdet names <- the JAX package's scopes (the inverse of its
    ``map_unet_v2``): the encoder's conv_input, conv1.0 <- conv1,
    conv{s}.0 <- down{s-1}, conv{s}.{1,2} <- subm{s-1}_{0,1}, conv_out
    (with RETURN_ENCODED_TENSOR); the decoder's conv_up_t{k} (bias-free
    residual blocks) <- up{k}_t, conv_up_m{k} <- up{k}_m, inv_conv{k} <-
    up{k}_inv, conv5.0 <- up1_post."""
    rules = []

    def block(tkey, scope, transform="spconv27"):
        rules.append((f"{tkey}.0.weight", "params", (top, scope, "kernel"), transform))
        rules.extend(_bn(f"{tkey}.1", (top, scope, "MaskedBatchNorm_0")))

    block("backbone_3d.conv_input", "conv_input")
    block("backbone_3d.conv1.0", "conv1")
    for s in (2, 3, 4):
        block(f"backbone_3d.conv{s}.0", f"down{s - 1}")
        for j in (1, 2):
            block(f"backbone_3d.conv{s}.{j}", f"subm{s - 1}_{j - 1}")
    if cfg.get("RETURN_ENCODED_TENSOR", True):
        block("backbone_3d.conv_out", "conv_out", "spconv3")
    for k in (4, 3, 2, 1):
        for j in (1, 2):
            p = (top, f"up{k}_t", f"conv{j}")
            rules.append((f"backbone_3d.conv_up_t{k}.conv{j}.weight", "params", (*p, "kernel"),
                          "spconv27"))
            rules.extend(_bn(f"backbone_3d.conv_up_t{k}.bn{j}", (*p, "MaskedBatchNorm_0")))
        block(f"backbone_3d.conv_up_m{k}", f"up{k}_m")
        if k > 1:
            block(f"backbone_3d.inv_conv{k}", f"up{k}_inv")
    block("backbone_3d.conv5.0", "up1_post")
    return rules


def _backbone_rules(cfg, top):
    """blocks.{i}.{1 + 3k} conv / .{2 + 3k} norm <- body/ConvBNReLU_{g}
    (numbered across blocks); deblocks.{i}.0 / .1 <- body/ConvTranspose_{t}
    or Conv_{c} and body/BatchNorm_{i}."""
    layer_nums = list(cfg.get("LAYER_NUMS", []))
    up_strides = list(cfg.get("UPSAMPLE_STRIDES", []))
    body = (top, "body")
    rules, g, n_ct, n_cv = [], 0, 0, 0
    for i, ln in enumerate(layer_nums):
        for k in range(ln + 1):
            seq = 1 + 3 * k
            rules.append((f"backbone_2d.blocks.{i}.{seq}.weight", "params",
                          (*body, f"ConvBNReLU_{g}", "Conv_0", "kernel"), "conv2d"))
            rules += _bn(f"backbone_2d.blocks.{i}.{seq + 1}", (*body, f"ConvBNReLU_{g}",
                                                              "BatchNorm_0"))
            g += 1
    for i, us in enumerate(up_strides):
        key = f"backbone_2d.deblocks.{i}.0.weight"
        if us > 1 or i >= len(layer_nums):
            rules.append((key, "params", (*body, f"ConvTranspose_{n_ct}", "kernel"), "deconv2d"))
            n_ct += 1
        else:
            rules.append((key, "params", (*body, f"Conv_{n_cv}", "kernel"),
                          "deconv2d" if us == 1 else "conv2d"))
            n_cv += 1
        rules += _bn(f"backbone_2d.deblocks.{i}.1", (*body, f"BatchNorm_{i}"))
    return rules


def _center_head_rules(cfg, top, class_names):
    bias = bool(cfg.get("USE_BIAS_BEFORE_NORM", False))
    rules = [("dense_head.shared_conv.0.weight", "params", (top, "shared_conv", "Conv_0",
                                                           "kernel"), "conv2d")]
    if bias:
        rules.append(("dense_head.shared_conv.0.bias", "params",
                      (top, "shared_conv", "Conv_0", "bias"), "copy"))
    rules += _bn("dense_head.shared_conv.1", (top, "shared_conv", "BatchNorm_0"))
    head_dict = dict(cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
    for h, names in enumerate(cfg["CLASS_NAMES_EACH_HEAD"]):
        specs = dict(head_dict)
        specs["hm"] = {"out_channels": len([n for n in names if n in class_names]),
                       "num_conv": cfg.get("NUM_HM_CONV", 2)}
        for name, spec in specs.items():
            t, p = f"dense_head.heads_list.{h}.{name}", (top, f"head_{h}")
            nc = int(spec["num_conv"])
            for j in range(nc - 1):
                conv = (*p, f"{name}_conv{j}", "Conv_0")
                rules.append((f"{t}.{j}.0.weight", "params", (*conv, "kernel"), "conv2d"))
                if bias:
                    rules.append((f"{t}.{j}.0.bias", "params", (*conv, "bias"), "copy"))
                rules += _bn(f"{t}.{j}.1", (*p, f"{name}_conv{j}", "BatchNorm_0"))
            rules.append((f"{t}.{nc - 1}.weight", "params", (*p, f"{name}_out", "kernel"),
                          "conv2d"))
            rules.append((f"{t}.{nc - 1}.bias", "params", (*p, f"{name}_out", "bias"), "copy"))
    return rules


def _anchor_head_rules(cfg, top):
    """conv_cls / conv_box / conv_dir_cls: 1x1 convs with bias."""
    names = ["conv_cls", "conv_box"]
    if cfg.get("USE_DIRECTION_CLASSIFIER", False):
        names.append("conv_dir_cls")
    return [rule for name in names
            for rule in ((f"dense_head.{name}.weight", "params", (top, name, "kernel"), "conv2d"),
                         (f"dense_head.{name}.bias", "params", (top, name, "bias"), "copy"))]


def _anchor_multi_rules(cfg, top):
    """AnchorHeadMulti: ``shared_conv`` <- shared_conv; per head i
    ``rpn_heads.{i}.conv_mid.{j}`` <- h{i}_mid{j} (ConvBNReLUs),
    ``conv_cls`` <- h{i}_cls, ``conv_box`` <- h{i}_box or, with
    SEPARATE_REG_CONFIG, ``conv_box.conv_{name}`` <- h{i}_reg_{name},
    ``conv_dir_cls`` <- h{i}_dir (1x1 convs with bias)."""
    def conv_bn(tkey, scope):
        return ([(f"{tkey}.0.weight", "params", (top, scope, "Conv_0", "kernel"), "conv2d")]
                + _bn(f"{tkey}.1", (top, scope, "BatchNorm_0")))

    def conv(tkey, scope):
        return [(f"{tkey}.weight", "params", (top, scope, "kernel"), "conv2d"),
                (f"{tkey}.bias", "params", (top, scope, "bias"), "copy")]

    sep = cfg.get("SEPARATE_REG_CONFIG")
    rules = conv_bn("dense_head.shared_conv", "shared_conv")
    for i in range(len(cfg["RPN_HEAD_CFGS"])):
        t = f"dense_head.rpn_heads.{i}"
        for j in range(int(sep.get("NUM_MIDDLE_CONV", 0)) if sep else 0):
            rules += conv_bn(f"{t}.conv_mid.{j}", f"h{i}_mid{j}")
        rules += conv(f"{t}.conv_cls", f"h{i}_cls")
        if sep:
            for reg in sep["REG_LIST"]:
                name = reg.split(":")[0]
                rules += conv(f"{t}.conv_box.conv_{name}", f"h{i}_reg_{name}")
        else:
            rules += conv(f"{t}.conv_box", f"h{i}_box")
        if cfg.get("USE_DIRECTION_CLASSIFIER", False):
            rules += conv(f"{t}.conv_dir_cls", f"h{i}_dir")
    return rules


def _fc_rules(tkey, top, name, fcs, transform, slot_after):
    """A pcdet FC Sequential ``tkey.{seq}`` <- ``{name}_fc_{i}`` and
    ``{name}_bn_{i}`` (the norm's variance shifted), seq stepping past
    pcdet's dropout slots; returns (rules, the next seq)."""
    rules, seq = [], 0
    for i in range(len(fcs)):
        rules.append((f"{tkey}.{seq}.weight", "params", (top, f"{name}_fc_{i}", "kernel"),
                      transform))
        rules += _bn(f"{tkey}.{seq + 1}", (top, f"{name}_bn_{i}"), var="var_shift")
        seq += 4 if slot_after(i) else 3
    return rules, seq


def _roi_head_rules(cfg, top):
    """VoxelRCNNHead: ``roi_grid_pool_layers.{i}.{pre,out,out_bn}`` <-
    ``pre_{src}`` (biased), ``out_{src}``, ``out_bn_{src}`` (com_tpu's folded
    pool); ``shared_fc_layer``, ``{cls,reg}_fc_layers``,
    ``{cls,reg}_pred_layer`` <- ``shared_fc_{i}``/``shared_bn_{i}``,
    ``{cls,reg}_fc_{i}``/``_bn_{i}``, ``{cls,reg}_out`` (the names
    ``com_tpu/utils/torch_import.py`` ``map_voxelrcnn_roi_head`` reads).
    SECONDHead: ``shared_fc_layer`` and ``iou_layers`` (Conv1d layout, the
    last entry <- ``rcnn_iou``)."""
    dp = float(cfg.get("DP_RATIO", 0.0))
    shared = list(cfg.get("SHARED_FC", [256, 256]))

    def not_last(n):
        return lambda i: dp > 0 and i != n - 1

    if cfg["NAME"] == "SECONDHead":
        rules, _ = _fc_rules("roi_head.shared_fc_layer", top, "shared", shared, "conv1d",
                             not_last(len(shared)))
        iou_rules, seq = _fc_rules("roi_head.iou_layers", top, "iou",
                                   list(cfg.get("IOU_FC", [256, 256])), "conv1d",
                                   lambda i: i == 0)
        return rules + iou_rules + [
            (f"roi_head.iou_layers.{seq}.weight", "params", (top, "rcnn_iou", "kernel"),
             "conv1d"),
            (f"roi_head.iou_layers.{seq}.bias", "params", (top, "rcnn_iou", "bias"), "copy")]
    pool = cfg["ROI_GRID_POOL"]
    rules = []
    for i, src in enumerate(pool.get("FEATURES_SOURCE", ["x_conv2", "x_conv3", "x_conv4"])):
        t = f"roi_head.roi_grid_pool_layers.{i}"
        rules += [(f"{t}.pre.weight", "params", (top, f"pre_{src}", "kernel"), "linear"),
                  (f"{t}.pre.bias", "params", (top, f"pre_{src}", "bias"), "copy"),
                  (f"{t}.out.weight", "params", (top, f"out_{src}", "kernel"), "linear")]
        rules += _bn(f"{t}.out_bn", (top, f"out_bn_{src}"))
    rules += _fc_rules("roi_head.shared_fc_layer", top, "shared", shared, "linear",
                       not_last(len(shared)))[0]
    for name in ("cls", "reg"):
        fcs = list(cfg.get(f"{name.upper()}_FC", [256, 256]))
        rules += _fc_rules(f"roi_head.{name}_fc_layers", top, name, fcs, "linear",
                           not_last(len(fcs)))[0]
        rules += [(f"roi_head.{name}_pred_layer.weight", "params", (top, f"{name}_out", "kernel"),
                   "linear"),
                  (f"roi_head.{name}_pred_layer.bias", "params", (top, f"{name}_out", "bias"),
                   "copy")]
    return rules


def _mlp_rules(tkey, path, n_layers, dense="Dense_{k}", bn="MaskedBatchNorm_{k}"):
    """A pcdet shared MLP ``{tkey}.{3k}`` (Conv2d 1x1) / ``.{3k + 1}`` <-
    ``{path}/{dense}`` / ``{bn}`` (variance shifted), k = 0, 1, ..."""
    rules = []
    for k in range(n_layers):
        rules.append((f"{tkey}.{3 * k}.weight", "params",
                      (*path, dense.format(k=k), "kernel"), "conv1x1"))
        rules += _bn(f"{tkey}.{3 * k + 1}", (*path, bn.format(k=k)), var="var_shift")
    return rules


def _sa_rules(tkey, top, scope, n_layers):
    """A pointnet2 block's ``{tkey}.mlps.0`` <- ``{scope}``'s auto-named
    Dense and MaskedBatchNorm scopes."""
    return _mlp_rules(f"{tkey}.mlps.0", (top, scope), n_layers)


def _pointnet2_rules(cfg, top):
    """PointNet2MSG: ``backbone_3d.SA_modules.{k}.mlps.{r}`` <- sa_{k}/mlp_{r},
    ``backbone_3d.FP_modules.{i}.mlp`` <- fp_{i}'s fc_{j} / bn_{j} (the
    inverse of the JAX package's ``map_pointnet2_msg``)."""
    rules = []
    for k, mlps in enumerate(cfg["SA_CONFIG"]["MLPS"]):
        for r, m in enumerate(mlps):
            rules += _mlp_rules(f"backbone_3d.SA_modules.{k}.mlps.{r}", (top, f"sa_{k}", f"mlp_{r}"),
                                len(m))
    for i, m in enumerate(cfg["FP_MLPS"]):
        rules += _mlp_rules(f"backbone_3d.FP_modules.{i}.mlp", (top, f"fp_{i}"), len(m),
                            dense="fc_{k}", bn="bn_{k}")
    return rules


def _pointrcnn_head_rules(cfg, top):
    """PointRCNNHead: ``roi_head.xyz_up_layer`` <- xyz_up_{k} / xyz_up_bn_{k},
    ``merge_down_layer`` <- merge_down_0 / merge_down_bn_0,
    ``SA_modules.{k}.mlps.0`` <- sa_{k}/mlp, ``{cls,reg}_layers`` <-
    {cls,reg}_fc_{i} / _bn_{i} and {cls,reg}_out (Conv1d layout; the inverse
    of the JAX package's ``map_pointrcnn_roi_head``)."""
    rules = _mlp_rules("roi_head.xyz_up_layer", (top,), len(cfg.get("XYZ_UP_LAYER", [128, 128])),
                       dense="xyz_up_{k}", bn="xyz_up_bn_{k}")
    rules += _mlp_rules("roi_head.merge_down_layer", (top,), 1, dense="merge_down_{k}",
                        bn="merge_down_bn_{k}")
    for k, m in enumerate(cfg["SA_CONFIG"]["MLPS"]):
        rules += _mlp_rules(f"roi_head.SA_modules.{k}.mlps.0", (top, f"sa_{k}", "mlp"), len(m))
    for name in ("cls", "reg"):
        rules += _branch_rules(f"roi_head.{name}_layers", top, name,
                               list(cfg.get(f"{name.upper()}_FC", [256, 256])), "conv1d",
                               lambda i: i == 0)
    return rules


def _branch_rules(tkey, top, name, fcs, transform, slot_after):
    """``_fc_rules`` and the biased output layer after them <- {name}_out."""
    rules, seq = _fc_rules(tkey, top, name, fcs, transform, slot_after)
    return rules + [(f"{tkey}.{seq}.weight", "params", (top, f"{name}_out", "kernel"), transform),
                    (f"{tkey}.{seq}.bias", "params", (top, f"{name}_out", "bias"), "copy")]


def _pfe_rules(cfg, top):
    """VoxelSetAbstraction: ``pfe.SA_rawpoints`` <- sa_raw, ``pfe.SA_layers.{k}``
    <- sa_{src}, ``pfe.vsa_point_feature_fusion.{0,1}`` <-
    vsa_point_feature_fusion / vsa_fusion_bn (the inverse of the JAX
    package's ``map_vsa``)."""
    sources = list(cfg.get("FEATURES_SOURCE", ["bev", "raw_points", "x_conv3", "x_conv4"]))
    sa = cfg.get("SA_LAYER", {})
    rules = []
    if "raw_points" in sources:
        n = len(sa.get("raw_points", {}).get("MLPS", [[16, 16]])[0])
        rules += _sa_rules("pfe.SA_rawpoints", top, "sa_raw", n)
    for k, src in enumerate(s for s in sources if s.startswith("x_conv")):
        n = len(sa.get(src, {}).get("MLPS", [[32, 32]])[0])
        rules += _sa_rules(f"pfe.SA_layers.{k}", top, f"sa_{src}", n)
    rules.append(("pfe.vsa_point_feature_fusion.0.weight", "params",
                  (top, "vsa_point_feature_fusion", "kernel"), "linear"))
    return rules + _bn("pfe.vsa_point_feature_fusion.1", (top, "vsa_fusion_bn"), var="var_shift")


def _point_head_rules(cfg, top):
    """PointHeadSimple: ``point_head.cls_layers`` <- cls_fc_{i} / cls_bn_{i},
    the output <- cls_out; PointHeadBox also ``point_head.box_layers`` <-
    box_fc_{i} / box_bn_{i} / box_out; PointIntraPartOffsetHead
    ``cls_layers``, ``part_reg_layers`` <- part_* and, with REG_FC,
    ``box_layers`` (its widths default to [128])."""
    if cfg.get("NAME") == "PointIntraPartOffsetHead":
        branches = [("cls", "cls", "CLS_FC"), ("part_reg", "part", "PART_FC")]
        branches += [("box", "box", "REG_FC")] if "REG_FC" in cfg else []
        default = [128]
    else:
        branches = [("cls", "cls", "CLS_FC")]
        branches += [("box", "box", "REG_FC")] if cfg["NAME"] == "PointHeadBox" else []
        default = [256, 256]
    return [rule for tname, name, key in branches
            for rule in _branch_rules(f"point_head.{tname}_layers", top, name,
                                      list(cfg.get(key, default)), "linear", lambda i: False)]


def _parta2_head_rules(cfg, top):
    """PartA2FCHead: ``roi_head.conv_{part,rpn}.{j}.0`` / ``.1`` <-
    conv_{part,rpn}_{j}'s Conv_0 (spconv layout) and MaskedBatchNorm_0
    (pcdet's eps 1e-3, unshifted); ``shared_fc_layer`` <- shared_fc_{i} /
    shared_bn_{i} (a dropout slot after each but the last when DP_RATIO >
    0), ``{cls,reg}_layers`` <- {cls,reg}_fc_{i} / _bn_{i} and {cls,reg}_out
    (Conv1d layout; the inverse of the JAX package's
    ``map_parta2_roi_head``)."""
    rules = []
    for stem in ("part", "rpn"):
        for j in (0, 1):
            p = (top, f"conv_{stem}_{j}")
            rules.append((f"roi_head.conv_{stem}.{j}.0.weight", "params", (*p, "Conv_0", "kernel"),
                          "spconv_dense"))
            rules += _bn(f"roi_head.conv_{stem}.{j}.1", (*p, "MaskedBatchNorm_0"))
    dp = float(cfg.get("DP_RATIO", 0.0))
    shared = list(cfg.get("SHARED_FC", [256, 256]))
    rules += _fc_rules("roi_head.shared_fc_layer", top, "shared", shared, "conv1d",
                       lambda i: dp > 0 and i != len(shared) - 1)[0]
    for name in ("cls", "reg"):
        rules += _branch_rules(f"roi_head.{name}_layers", top, name,
                               list(cfg.get(f"{name.upper()}_FC", [256, 256])), "conv1d",
                               lambda i: i == 0)
    return rules


def _pvrcnn_head_rules(cfg, top):
    """PVRCNNHead: ``roi_grid_pool_layer`` <- roi_grid_pointnet,
    ``shared_fc_layer`` <- shared_fc_{i} / shared_bn_{i}, ``{cls,reg}_layers``
    <- {cls,reg}_fc_{i} / _bn_{i} and rcnn_{cls,reg} (Conv1d layout; the
    inverse of the JAX package's ``map_pvrcnn_roi_head``)."""
    pool = cfg.get("ROI_GRID_POOL", {})
    rules = _sa_rules("roi_head.roi_grid_pool_layer", top, "roi_grid_pointnet",
                      len(pool.get("MLPS", [[64, 64]])[0]))
    dp = float(cfg.get("DP_RATIO", 0.0))
    shared = list(cfg.get("SHARED_FC", [256, 256]))
    rules += _fc_rules("roi_head.shared_fc_layer", top, "shared", shared, "conv1d",
                       lambda i: dp > 0 and i != len(shared) - 1)[0]
    for name in ("cls", "reg"):
        fc_rules, seq = _fc_rules(f"roi_head.{name}_layers", top, name,
                                  list(cfg.get(f"{name.upper()}_FC", [])), "conv1d",
                                  lambda i: i == 0)
        rules += fc_rules + [
            (f"roi_head.{name}_layers.{seq}.weight", "params", (top, f"rcnn_{name}", "kernel"),
             "conv1d"),
            (f"roi_head.{name}_layers.{seq}.bias", "params", (top, f"rcnn_{name}", "bias"), "copy")]
    return rules


def _pvrcnn_plusplus_head_rules(cfg, top):
    """PVRCNNPlusPlusHead: the flax scopes' own names under ``roi_head.``
    (pcdet has no importer rule for it), Linear layout, norms unshifted."""
    def lin(name, bias=False):
        out = [(f"roi_head.{name}.weight", "params", (top, name, "kernel"), "linear")]
        return out + ([(f"roi_head.{name}.bias", "params", (top, name, "bias"), "copy")]
                      if bias else [])

    from ..models.roi_heads.pvrcnn_head import DEFAULT_GROUPS

    rules = []
    for gi, gc in enumerate(cfg.get("ROI_GRID_POOL", {}).get("GROUPS", DEFAULT_GROUPS)):
        for li in range(len(gc.get("POST_MLPS", [64]))):
            bn = f"g{gi}_bn_{li}"
            rules += lin(f"g{gi}_mlp_{li}") + _bn(f"roi_head.{bn}", (top, bn))
    for i in range(len(cfg.get("SHARED_FC", [256, 256]))):
        rules += lin(f"shared_fc_{i}") + _bn(f"roi_head.shared_bn_{i}", (top, f"shared_bn_{i}"))
    for name in ("cls", "reg"):
        for i in range(len(cfg.get(f"{name.upper()}_FC", []))):
            rules += lin(f"{name}_fc_{i}") + _bn(f"roi_head.{name}_bn_{i}", (top, f"{name}_bn_{i}"))
        rules += lin(f"rcnn_{name}", bias=True)
    return rules


def _dense(tkey, path, bias=True):
    """A flax Dense at ``path`` -> Linear ``tkey``."""
    out = [(f"{tkey}.weight", "params", (*path, "kernel"), "linear")]
    return out + ([(f"{tkey}.bias", "params", (*path, "bias"), "copy")] if bias else [])


def _ln(tkey, path):
    """A flax LayerNorm -> nn.LayerNorm."""
    return [(f"{tkey}.weight", "params", (*path, "scale"), "copy"),
            (f"{tkey}.bias", "params", (*path, "bias"), "copy")]


def _mlp(tkey, path, n):
    """MPPNet's ``MLP``: ``{tkey}.layers.{i}`` <- ``{path}/Dense_{i}``."""
    return [r for i in range(n) for r in _dense(f"{tkey}.layers.{i}", (*path, f"Dense_{i}"))]


def _attention(tkey, path):
    return [rule for name in ("query", "key", "value", "out")
            for rule in ((f"{tkey}.{name}.weight", "params", (*path, name, "kernel"),
                          "mha_out" if name == "out" else "mha_in"),
                         (f"{tkey}.{name}.bias", "params", (*path, name, "bias"),
                          "copy" if name == "out" else "flatten"))]


def _ffn(tkey, path):
    """``FFN``: linear1 <- Dense_1, linear2 <- Dense_0 (flax names the outer
    Dense first), norm{1,2} <- LayerNorm_{0,1}."""
    return (_dense(f"{tkey}.linear1", (*path, "Dense_1"))
            + _dense(f"{tkey}.linear2", (*path, "Dense_0"))
            + _ln(f"{tkey}.norm1", (*path, "LayerNorm_0"))
            + _ln(f"{tkey}.norm2", (*path, "LayerNorm_1")))


def _mppnet_head_rules(cfg, top):
    """MPPNetHead and MPPNetHeadE2E: the flax scopes' names (pcdet's importer
    has no table for them), MLPs' ``Dense_{i}`` as ``layers.{i}``; the
    transformer's layers as ``com_tpu_torch/models/mppnet/transformer.py``
    names them; ``seqboxembed``'s auto-named Dense and BatchNorm scopes by
    their order of creation (fc1, fc2, then each residual's output before
    its hidden layer)."""
    t = "roi_head"
    tcfg = cfg["Transformer"]
    groups, frames = int(tcfg["num_groups"]), int(tcfg["num_frames"])
    rules = (_mlp(f"{t}.up_dimension_geometry", (top, "up_dimension_geometry"), 3)
             + _mlp(f"{t}.up_dimension_motion", (top, "up_dimension_motion"), 3)
             + _mlp(f"{t}.jointembed", (top, "jointembed"), 4)
             + _mlp(f"{t}.grid_pos_embeded", (top, "grid_pos_embeded"), 2)
             + _dense(f"{t}.class_embed", (top, "class_embed")))
    if cfg["NAME"] == "MPPNetHead":  # the E2E head never calls its per-group boxes
        for g in range(groups):
            rules += _mlp(f"{t}.bbox_embed.{g}", (top, f"bbox_embed_{g}"), 4)
    for r, mlp in enumerate(cfg["ROI_GRID_POOL"]["MLPS"]):
        for li in range(len(mlp)):
            rules += _dense(f"{t}.roi_grid_pool_layers.{r}.{li}", (top, f"pool_r{r}_l{li}"))
    sb, s = f"{t}.seqboxembed", (top, "seqboxembed")
    rules += _bn(f"{sb}.pre_bn", (*s, "pre_bn"))
    for i in range(4):
        rules += _dense(f"{sb}.feat.fcs.{i}", (*s, "PointNetFeat_0", f"Dense_{i}"))
        rules += _bn(f"{sb}.feat.bns.{i}", (*s, "PointNetFeat_0", f"BatchNorm_{i}"))
    for i, name in enumerate(("fc1", "fc2")):
        rules += _dense(f"{sb}.{name}", (*s, f"Dense_{i}")) + _bn(f"{sb}.bn{i + 1}",
                                                                 (*s, f"BatchNorm_{i}"))
    for i, name in enumerate(("center", "size", "heading")):
        rules += _dense(f"{sb}.{name}_out", (*s, f"Dense_{2 + 2 * i}"), bias=False)
        rules += _dense(f"{sb}.{name}_hidden", (*s, f"Dense_{3 + 2 * i}"))
    tr, tp = f"{t}.transformer", (top, "transformer")
    rules.append((f"{tr}.token", "params", (*tp, "token"), "copy"))
    if frames > 4:
        rules += _mlp(f"{tr}.fusion_all_group", (*tp, "fusion_all_group"), 4)
        rules += _ffn(f"{tr}.fusion_norm", (*tp, "fusion_norm"))
    n_layers = int(tcfg["enc_layers"])
    for li in range(n_layers):
        lt, lp = f"{tr}.layers.{li}", (*tp, f"layer_{li}")
        mt, mp = f"{lt}.mixer", (*lp, "SpatialMixerBlock_0")
        for a in ("x", "y", "z"):
            rules += _mlp(f"{mt}.mixer_{a}", (*mp, f"mixer_{a}"), 3)
            rules += _ln(f"{mt}.mixer_{a}_norm", (*mp, f"mixer_{a}_norm"))
        rules += (_dense(f"{mt}.linear1", (*mp, "Dense_0"))
                  + _dense(f"{mt}.linear2", (*mp, "Dense_1"))
                  + _ln(f"{mt}.norm", (*mp, "LayerNorm_0")))
        rules += _attention(f"{lt}.self_attn", (*lp, "MultiHeadDotProductAttention_0"))
        rules += (_ln(f"{lt}.norm1", (*lp, "LayerNorm_0"))
                  + _ln(f"{lt}.norm2", (*lp, "LayerNorm_1"))
                  + _dense(f"{lt}.linear1", (*lp, "Dense_1"))
                  + _dense(f"{lt}.linear2", (*lp, "Dense_0")))
        if li < n_layers - 1:
            rules += _mlp(f"{lt}.fusion_all_groups", (*lp, "fusion_all_groups"), 4)
            rules += _ffn(f"{lt}.ffn", (*lp, "FFN_0"))
            for g in range(groups):
                rules += _attention(f"{lt}.cross_attn.{g}", (*lp, f"cross_attn_{g}"))
    return rules


def bridge_rules(model_cfg, class_names, params) -> list:
    """Every (pcdet key, collection, flax path, transform) of the model.
    ``params`` (the flax "params" tree) gives the top-level scope names."""
    def top(*prefixes):
        for prefix in prefixes:
            for name in params:
                if name.startswith(prefix):
                    return name
        raise KeyError(f"no flax scope starting with {prefixes!r} in {sorted(params)}")

    rules = []
    vfe = model_cfg.get("VFE") or {}
    if vfe.get("NUM_FILTERS"):
        rules += _pfn_rules(vfe, top(vfe["NAME"]))
    b3 = model_cfg.get("BACKBONE_3D")
    if b3 is not None and b3["NAME"] == "PointNet2MSG":  # PointRCNN's, scope "backbone_3d"
        rules += _pointnet2_rules(b3, top("backbone_3d"))
    elif b3 is not None and b3["NAME"] == "UNetV2":  # PartA2's
        rules += _unet_v2_rules(b3, top("UNetV2"))
    elif b3 is not None:
        rules += _voxel_backbone_rules(top(b3["NAME"]),
                                       residual=b3["NAME"] == "VoxelResBackBone8x")
    if model_cfg.get("BACKBONE_2D") is not None:
        rules += _backbone_rules(model_cfg["BACKBONE_2D"], top("BaseBEVBackbone"))
    head = model_cfg.get("DENSE_HEAD")
    if head is None:  # PointRCNN: no dense head
        pass
    elif head.get("NAME") == "AnchorHeadMulti":
        rules += _anchor_multi_rules(head, top("AnchorHeadMulti"))
    elif "ANCHOR_GENERATOR_CONFIG" in head:
        rules += _anchor_head_rules(head, top("AnchorHeadSingle"))  # every alias's flax scope
    else:
        rules += _center_head_rules(head, top("CenterHead"), list(class_names))
    if model_cfg.get("PFE") is not None:
        rules += _pfe_rules(model_cfg["PFE"], top("VoxelSetAbstraction"))
    if model_cfg.get("POINT_HEAD") is not None:
        rules += _point_head_rules(model_cfg["POINT_HEAD"], top("point_head"))
    roi = model_cfg.get("ROI_HEAD")
    if roi is not None:
        # PVRCNN's head is the auto-named PVRCNNHead_0; the others "roi_head"
        roi_top = top("roi_head", roi["NAME"])
        if roi["NAME"] == "PVRCNNHead":
            rules += _pvrcnn_head_rules(roi, roi_top)
        elif roi["NAME"] == "PointRCNNHead":
            rules += _pointrcnn_head_rules(roi, roi_top)
        elif roi["NAME"] == "PartA2FCHead":
            rules += _parta2_head_rules(roi, roi_top)
        elif roi["NAME"] == "PVRCNNPlusPlusHead":
            rules += _pvrcnn_plusplus_head_rules(roi, roi_top)
        elif roi["NAME"] in ("MPPNetHead", "MPPNetHeadE2E"):
            rules += _mppnet_head_rules(roi, roi_top)
        else:
            rules += _roi_head_rules(roi, roi_top)
    return rules


def _leaf(tree, path, transform):
    for part in path:
        tree = tree[part]
    fn = _TRANSFORMS.get(transform) or _STAT_TRANSFORMS[transform]
    return np.array(fn(np.asarray(tree, np.float32)), order="C")


def state_dict_from_jax(variables, model_cfg, class_names) -> dict:
    """{pcdet key: numpy array} from flax ``{"params", "batch_stats"}``."""
    return {key: _leaf(variables[coll], path, transform)
            for key, coll, path, transform in bridge_rules(model_cfg, class_names,
                                                           variables["params"])}


def params_from_jax(params, model_cfg, class_names) -> dict:
    """{pcdet key: numpy array} of the parameters alone, from a tree shaped
    like flax "params": the parameters, their gradients or their update.
    The layout changes are linear, so a gradient maps as its parameter."""
    return {key: _leaf(params, path, transform)
            for key, coll, path, transform in bridge_rules(model_cfg, class_names, params)
            if coll == "params"}


def curriculum_state_from_jax(states, device=None) -> tuple:
    """The JAX package's per-head curriculum states as the port's: each a
    ``CurriculumState`` or an ``AnchorCurriculumState`` (fields ``means``,
    ``stds``, ``initialized``), as a NamedTuple or the dict a raw restore
    gives."""
    from ..losses.anchor_losses import AnchorCurriculumState
    from ..losses.curriculum import CurriculumState

    out = []
    for s in states:
        fields = s._asdict() if hasattr(s, "_asdict") else dict(s)
        cls = AnchorCurriculumState if "means" in fields else CurriculumState
        out.append(cls(*(torch.as_tensor(np.array(fields[f]), device=device,
                                         dtype=torch.bool if f == "initialized" else torch.float32)
                         for f in cls._fields)))
    return tuple(out)


def sampler_state_from_jax(payload, dataset) -> np.ndarray:
    """Carry the COMAug sampler state of a JAX checkpoint,
    ``{"confidence_groups": (C, G) array}`` (``com_tpu/train/loop.py``
    ``sampler_state``), into the port's ``dataset`` through
    ``set_confidence_groups``; returns the confidences as numpy."""
    conf = np.array(payload["confidence_groups"], np.float32)
    if conf.ndim != 2:
        raise ValueError(f"confidence_groups is (classes, groups), got {conf.shape}")
    dataset.set_confidence_groups(conf)
    return conf


def load_jax_variables(net: torch.nn.Module, variables, model_cfg, class_names):
    """Load flax variables (nested dicts of arrays) into ``net`` in place.
    Every parameter and running statistic of ``net`` must be covered."""
    sd = state_dict_from_jax(variables, model_cfg, class_names)
    own = net.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    unknown = [k for k in sd if k not in own]
    if missing or unknown:
        raise KeyError(f"weight bridge: missing {missing}, unknown {unknown}")
    with torch.no_grad():
        for k, v in sd.items():
            if tuple(own[k].shape) != v.shape:
                raise ValueError(f"weight bridge: {k} is {tuple(own[k].shape)}, got {v.shape}")
            own[k].copy_(torch.from_numpy(v))
    return net


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _optax_leaves(node, adam, counts):
    """Walk an optax state (NamedTuples, or the dicts and lists a raw restore
    gives): the states with ``mu`` and ``nu`` into ``adam``, every ``count``
    into ``counts``."""
    if hasattr(node, "_asdict"):
        items = node._asdict()
    elif isinstance(node, dict):
        items = node
    elif isinstance(node, (list, tuple)):
        items = dict(enumerate(node))
    else:
        return
    if "mu" in items and "nu" in items:
        adam.append(items)
    if "count" in items:
        counts.append(int(np.asarray(items["count"])))
    for k, v in items.items():
        if k not in ("mu", "nu", "count"):
            _optax_leaves(v, adam, counts)


def train_state_from_jax(payload, state, model_cfg, class_names, dataset=None):
    """Carry a ``com_tpu`` checkpoint payload (``{"state": TrainState,
    "meta", "sampler"}`` as ``com_tpu.utils.checkpoint.load_checkpoint``
    reads it) into the port's ``state`` in place: parameters and batch
    statistics, Adam's ``mu``/``nu`` of the ``adam_onecycle`` chain
    (``clip_by_global_norm``, ``inject_hyperparams(scale_by_adam)``,
    ``add_decayed_weights``, ``scale_by_schedule``) under the parameters'
    layout rules, the step count (every optax ``count`` must equal the
    state's step), the curriculum states and the epoch accumulators; with
    ``dataset``, the sampler's confidences too.  Returns ``state``."""
    js = payload["state"]
    load_jax_variables(state.net, {"params": _field(js, "params"),
                                   "batch_stats": _field(js, "batch_stats")},
                       model_cfg, class_names)
    adam, counts = [], []
    _optax_leaves(_field(js, "opt_state"), adam, counts)
    step = int(np.asarray(_field(js, "step")))
    if len(adam) != 1 or not counts or set(counts) != {step}:
        raise ValueError(f"optax state: {len(adam)} Adam states, counts {counts}, step {step}")
    mu = params_from_jax(adam[0]["mu"], model_cfg, class_names)
    nu = params_from_jax(adam[0]["nu"], model_cfg, class_names)
    params = dict(state.net.named_parameters())
    if set(mu) != set(params):
        raise KeyError(f"Adam moments: {sorted(set(params) ^ set(mu))} differ")
    opt = state.optimizer
    for k, p in params.items():
        opt.state[p] = {"mu": torch.from_numpy(mu[k]).to(device=p.device, dtype=p.dtype),
                        "nu": torch.from_numpy(nu[k]).to(device=p.device, dtype=p.dtype)}
    opt.count = state.step = step
    state.curriculum = curriculum_state_from_jax(_field(js, "curriculum"), device=state.device)
    conf_sum = _field(js, "conf_sum")
    if state.conf_sum is not None and conf_sum is not None:
        state.conf_sum.copy_(torch.from_numpy(np.array(conf_sum, np.float32)))
        state.conf_cnt.copy_(torch.from_numpy(np.array(_field(js, "conf_cnt"), np.float32)))
    if dataset is not None and payload.get("sampler") is not None:
        sampler_state_from_jax(payload["sampler"], dataset)
    return state
