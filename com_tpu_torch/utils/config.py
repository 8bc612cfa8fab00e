"""YAML config system with inheritance and CLI overrides (the port's copy of
``com_tpu/utils/config.py``).

Mirrors the reference config semantics (pcdet/config.py:16-85): a global config
tree loaded from YAML, `_BASE_CONFIG_` include-merge, and dotted-path
``--set KEY VALUE`` overrides with literal-eval type preservation.  We use a
small attribute-dict instead of a third-party EasyDict.
"""
from __future__ import annotations

import copy
from ast import literal_eval
from pathlib import Path

import yaml


class CfgNode(dict):
    """A dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, d=None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = _wrap(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = _wrap(value)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out

    def clone(self):
        return copy.deepcopy(self)


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, CfgNode):
        return CfgNode(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def merge_new_config(config: CfgNode, new_config: dict) -> CfgNode:
    """Recursively merge ``new_config`` into ``config``, honoring _BASE_CONFIG_."""
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"]) as f:
            base = yaml.safe_load(f)
        merge_new_config(config, base)

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), CfgNode):
                config[key] = CfgNode()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: CfgNode | None = None) -> CfgNode:
    if config is None:
        config = CfgNode()
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config, new_config)
    config["TAG"] = Path(cfg_file).stem
    # path of the config relative to the configs/cfgs root at ANY depth
    # (reference config.py: '/'.join(cfg_file.split('/')[1:-1])), so
    # configs/waymo_models/x.yaml -> waymo_models and
    # configs/waymo_models/com/x.yaml -> waymo_models/com land in one tree
    parts = [p for p in Path(cfg_file).resolve().parts[:-1] if p != "/"]
    for root in ("configs", "cfgs"):
        if root in parts:
            parts = parts[parts.index(root) + 1:]
            break
    else:
        parts = parts[-2:]
    config["EXP_GROUP_PATH"] = "/".join(parts)
    return config


def cfg_from_list(cfg_list, config: CfgNode) -> None:
    """Set config keys from a list of dotted-path key/value pairs.

    Mirrors the reference ``--set`` semantics (pcdet/config.py:16-48) including
    the ``KEY.0.SUBKEY`` list-index form and literal_eval type checking.
    """
    assert len(cfg_list) % 2 == 0, "override list must be key/value pairs"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey.isdigit():
                # positional index into a list entry (KEY.0.SUBKEY form)
                assert isinstance(d, (list, tuple)), (
                    f"{k}: {subkey} indexes a non-list config node")
                assert int(subkey) < len(d), (
                    f"{k}: index {subkey} out of range ({len(d)} entries)")
                d = d[int(subkey)]
            else:
                assert subkey in d, f"unknown config key: {k}"
                d = d[subkey]
        subkey = key_list[-1]
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if subkey in d and d[subkey] is not None and not isinstance(value, type(d[subkey])):
            if isinstance(d[subkey], CfgNode) and isinstance(value, str):
                # KEY:VALUE shorthand inside a dict node
                kk, vv = value.split(":")
                d[subkey][kk] = literal_eval(vv)
                continue
            assert type(value) == type(d[subkey]), f"type mismatch for {k}: {value}"
        d[subkey] = value



def log_config_to_file(cfg: CfgNode, pre="cfg", logger=None):
    for key, val in cfg.items():
        if isinstance(val, CfgNode):
            logger.info("----------- %s.%s -----------", pre, key)
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
        else:
            logger.info("%s.%s: %s", pre, key, val)
