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
PointPillar, CenterPoint-voxel and SECOND slots: DynamicPillarVFE,
VoxelBackBone8x and VoxelResBackBone8x, BaseBEVBackbone, CenterHead and
AnchorHeadSingle (its 1x1 convs, plain conv layout).  For comparing a train
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
}


def _bn(tkey, path):
    """(pcdet key, collection, flax path, transform) for one batch norm."""
    return [(f"{tkey}.weight", "params", (*path, "scale"), "copy"),
            (f"{tkey}.bias", "params", (*path, "bias"), "copy"),
            (f"{tkey}.running_mean", "batch_stats", (*path, "mean"), "copy"),
            (f"{tkey}.running_var", "batch_stats", (*path, "var"), "copy")]


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


def bridge_rules(model_cfg, class_names, params) -> list:
    """Every (pcdet key, collection, flax path, transform) of the model.
    ``params`` (the flax "params" tree) gives the top-level scope names."""
    def top(prefix):
        for name in params:
            if name.startswith(prefix):
                return name
        raise KeyError(f"no flax scope starting with {prefix!r} in {sorted(params)}")

    rules = []
    if model_cfg["VFE"].get("NUM_FILTERS"):
        rules += _pfn_rules(model_cfg["VFE"], top(model_cfg["VFE"]["NAME"]))
    b3 = model_cfg.get("BACKBONE_3D")
    if b3 is not None:
        rules += _voxel_backbone_rules(top(b3["NAME"]),
                                       residual=b3["NAME"] == "VoxelResBackBone8x")
    if model_cfg.get("BACKBONE_2D") is not None:
        rules += _backbone_rules(model_cfg["BACKBONE_2D"], top("BaseBEVBackbone"))
    head = model_cfg["DENSE_HEAD"]
    if "ANCHOR_GENERATOR_CONFIG" in head:
        rules += _anchor_head_rules(head, top("AnchorHeadSingle"))  # every alias's flax scope
    else:
        rules += _center_head_rules(head, top("CenterHead"), list(class_names))
    return rules


def _leaf(tree, path, transform):
    for part in path:
        tree = tree[part]
    return np.array(_TRANSFORMS[transform](np.asarray(tree, np.float32)), order="C")


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
